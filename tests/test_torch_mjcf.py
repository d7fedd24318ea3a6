"""PyTorch port parity: the MJCF compiler (`physics/mjcf.py`).

The suite XMLs are not in the repository, so inline MJCF strings
(`tests/mjcf_models.py`) cover the compiler's features: each compiles
with the JAX package's `mjcf.load_model_string` (or `load_model`) and the
port's, and the two models are equal field for field, the geom, camera and tendon specs
included (`tests/torch_domain_checks.py::assert_models_equal`, exact).
"""

import numpy as np
import pytest

from sgqn_carla_tpu.physics import mjcf as jmjcf
from sgqn_carla_tpu_torch.physics import mjcf as tmjcf
from mjcf_models import CART, COMMON, DEFAULTS, FLOOR, MAIN, TENDONS, WELD
from torch_domain_checks import assert_models_equal


@pytest.mark.parametrize("name,xml", [
    ("cart", CART), ("defaults", DEFAULTS), ("weld", WELD),
    ("tendons", TENDONS)])
def test_inline_model_matches_jax(name, xml):
    jm = jmjcf.load_model_string(xml)
    tm = tmjcf.load_model_string(xml)
    assert_models_equal(jm, tm)
    assert len(tm.geoms) > 1 and tm.nl >= 1


def test_include_splices_other_files(tmp_path):
    """`<include>` at the top level (option and defaults) and inside the
    worldbody (the floor), resolved against the including file's folder."""
    (tmp_path / "common").mkdir()
    (tmp_path / "common" / "defaults.xml").write_text(COMMON)
    (tmp_path / "common" / "floor.xml").write_text(FLOOR)
    path = tmp_path / "pendulum.xml"
    path.write_text(MAIN)
    jm = jmjcf.load_model(str(path))
    tm = tmjcf.load_model(str(path))
    assert_models_equal(jm, tm)
    assert tm.timestep == 0.008 and tm.geoms[0].name == "floor"
    np.testing.assert_allclose(tm.geoms[1].rgba, (0.7, 0.1, 0.1, 1))
    with pytest.raises(ValueError, match="base dir"):
        tmjcf.load_model_string(MAIN)
