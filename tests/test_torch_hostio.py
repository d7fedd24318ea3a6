"""PyTorch port parity: the host-I/O library's bindings (`core/native.py`)
and the PNG writers built on them.

The port builds `native/hostio.cpp` itself (into build/hostio/) and binds
it as the JAX package's `core/native.py` does: PNGs written in a batch
decode to the frames; `resize_bilinear` and `synth_pool` equal JAX
`native`'s outputs; the eval recorder writes through the batch encoder.
Where the library cannot be built, each entry point falls back as JAX's
does, and the recorder's PNGs still decode to the frames.
"""

import os

import matplotlib.image as mpimg
import numpy as np
import pytest

from sgqn_carla_tpu.core import native as jnative
from sgqn_carla_tpu_torch.core import native
from sgqn_carla_tpu_torch.train.video import VideoRecorder


def _read(path):
    return (mpimg.imread(path)[..., :3] * 255.0 + 0.5).astype(np.uint8)


def _frames(n=8, h=20, w=28, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, h, w, 3)).astype(
        np.uint8)


def test_png_write_batch_decodes_to_the_frames(tmp_path):
    assert native.available()
    lib = native.build()
    assert os.path.dirname(lib).endswith(os.path.join("build", "hostio"))
    frames = _frames()
    paths = [str(tmp_path / f"f{i}.png") for i in range(len(frames))]
    assert native.png_write_batch(frames, paths)
    for p, f in zip(paths, frames):
        np.testing.assert_array_equal(_read(p), f)
    with pytest.raises(ValueError):
        native.png_write_batch(frames, paths[:3])


def test_resize_and_synth_pool_equal_jax_native():
    img = _frames(1, 37, 53, seed=1)[0]
    for dh, dw in ((84, 84), (20, 31)):
        np.testing.assert_array_equal(native.resize_bilinear(img, dh, dw),
                                      jnative.resize_bilinear(img, dh, dw))
    np.testing.assert_array_equal(native.synth_pool(3, 16, 24, seed=5),
                                  jnative.synth_pool(3, 16, 24, seed=5))


def test_recorder_writes_through_the_library(tmp_path, monkeypatch):
    calls = []
    real = native.png_write_batch

    def spy(frames, paths):
        calls.append(len(paths))
        return real(frames, paths)

    monkeypatch.setattr(native, "png_write_batch", spy)
    rec = VideoRecorder(str(tmp_path), height=20, width=28)
    rec.init()
    frames = _frames(10)
    rec.record_frames(frames)
    paths = rec.save("5.mp4")
    assert calls == [5]  # every ⌈10/8⌉ = 2nd frame
    assert paths[0].endswith("5.npy")
    for p, i in zip(paths[1:], range(0, 10, 2)):
        assert p.endswith(f"5_f{i:04d}.png")
        np.testing.assert_array_equal(_read(p), frames[i])


def test_fallbacks_without_the_library(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_SRC", str(tmp_path / "missing.cpp"))
    monkeypatch.setattr(native, "_BUILD", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    assert not native.available()
    frames = _frames(2)
    assert native.png_write_batch(frames, ["a.png", "b.png"]) is False
    assert native.synth_pool(2, 8, 8) is None
    img = _frames(1, 10, 10)[0]
    np.testing.assert_array_equal(native.resize_bilinear(img, 5, 5),
                                  img[::2, ::2])
    rec = VideoRecorder(str(tmp_path / "video"), height=20, width=28)
    rec.init()
    rec.record_frames(frames)
    paths = rec.save("0.mp4")
    assert len(paths) == 3
    for p, f in zip(paths[1:], frames):
        np.testing.assert_array_equal(_read(p), f)
