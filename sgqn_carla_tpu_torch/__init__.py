"""sgqn_carla_tpu_torch — the PyTorch/CUDA port of sgqn_carla_tpu.

A second package beside the JAX one (which stays the reference): the same
module tree and names, PyTorch idiom inside, one hand-written CUDA kernel
(csrc/raycast.cu, the ray-caster that replaces the Pallas TPU kernel
render/pallas_raster.py). It imports torch, numpy and the standard library
only. Entry points run on the card (`--device cuda`, the default) unless
the caller asks for the CPU.

This slice carries walker SAC training from pixels:
  core/      config (+ `device`), JSONL logger
  physics/   scalar-SoA Featherstone engine, walker domain, rewards
  render/    ray-cast primitives, cameras, the CUDA ray-cast kernel
  envs/      batched pixel env (train mode), vector wrapper
  data/      device-resident replay ring
  ops/       3-vector algebra, crops
  agents/    SAC nets and update, JAX weight converter
  train/     fused loop, run_training, CLI
  parallel/  data parallelism over torch.distributed, the staged dryrun
"""

__version__ = "0.1.0"
