"""PyTorch port parity: quadruped escape through the pixel env.

Reset from the JAX env reset's physics (its start, filter state and
terrain, injected), then one wrapper step of the same actions: frames
(the terrain pass over the plain version of the kernel) within
`test_torch_env._frames_close`, rewards within 1e-4, qpos within 1e-4,
the terrain carried unchanged and drawn. One JAX env program (its reset
and its jitted step at action repeat 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sgqn_carla_tpu.envs.base import make_env as jmake_env
from sgqn_carla_tpu.envs.vector import VectorEnv as JVectorEnv
from sgqn_carla_tpu_torch.envs.base import make_env
from sgqn_carla_tpu_torch.envs.vector import VectorEnv
from sgqn_carla_tpu_torch.physics import hfield as hf
from sgqn_carla_tpu_torch.render import raycast
from test_torch_domains_env import _phys
from test_torch_env import _frames_close

E = 2


def test_escape_episode_with_injected_start_matches_jax():
    kw = dict(episode_length=8, action_repeat=1, image_size=84)
    jvenv = JVectorEnv(jmake_env("quadruped", "escape", **kw), E)
    jstates, jobs = jvenv.reset(jax.random.PRNGKey(7))
    env = make_env("quadruped", "escape", device="cpu", **kw)
    states, obs = VectorEnv(env, E).reset(None, phys=_phys(jstates.phys))
    terrain = states.phys.task_aux["terrain"]
    assert terrain.shape == (E, hf.RES, hf.RES)
    assert not torch.equal(terrain[0], terrain[1])
    _frames_close(obs.numpy(), np.asarray(jobs))
    a = np.random.RandomState(0).uniform(-1, 1, (E, 12)).astype(np.float32)
    jstates, jres = jax.jit(jvenv.step)(jstates, jnp.asarray(a))
    states, res = env.step(states, torch.from_numpy(a))
    _frames_close(res.obs.numpy(), np.asarray(jres.obs))
    np.testing.assert_allclose(res.reward.numpy(), np.asarray(jres.reward),
                               atol=1e-4)
    np.testing.assert_allclose(states.phys.qpos.numpy(),
                               np.asarray(jstates.phys.qpos), atol=1e-4)
    assert torch.equal(states.phys.task_aux["terrain"], terrain)
    # the terrain is drawn: its geom index on most of the frame
    sc = env.scene(states)
    _, seg = raycast.render_batch(**{k: v for k, v in sc.items() if k not in (
        "background", "bg_mask_materials")})
    assert (seg == env.task.model.hfield_geom).float().mean() > 0.3
