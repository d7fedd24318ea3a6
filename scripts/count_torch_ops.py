"""Count the eager PyTorch operations of the port's hot paths.

    python scripts/count_torch_ops.py

Each operation is one kernel launch when the port runs on the card, so
these counts bound how fast eager mode can go (PERF.md, "Where the time
goes"). Prints one JSON line: ops per walker physics substep, per reward,
per env step (16 envs, 84 px: physics, rewards and the render), per
full-width SAC update at an odd step (critic only: "sac_update") and an
even one (critic, actor, targets), and per full-width SGQN (sgsac) update
at an odd step (mask, critic with the consistency forwards) and an even
one (also actor, targets and the aux step), with the mask step alone.
Runs on the CPU; the counts do not depend on the batch size or the
device.
"""

import collections
import json
import os
import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sgqn_carla_tpu_torch.agents.sac import SAC  # noqa: E402
from sgqn_carla_tpu_torch.agents.sgsac import SGSAC  # noqa: E402
from sgqn_carla_tpu_torch.core.config import Config  # noqa: E402
from sgqn_carla_tpu_torch.data.overlay import synth_images  # noqa: E402
from sgqn_carla_tpu_torch.data.replay import ReplayBuffer  # noqa: E402
from sgqn_carla_tpu_torch.envs import make_env  # noqa: E402
from sgqn_carla_tpu_torch.envs.vector import VectorEnv  # noqa: E402
from sgqn_carla_tpu_torch.physics import engine  # noqa: E402


class Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


def count(fn):
    with Count() as c:
        fn()
    return sum(c.ops.values())


def main():
    g = torch.Generator().manual_seed(0)
    env = make_env("walker", "walk", image_size=84, device="cpu")
    venv = VectorEnv(env, 16)
    states, obs = venv.reset(g)
    a = torch.zeros(16, env.action_size)
    task, phys = env.task, states.phys
    out = {
        "substep": count(lambda: engine.step(task.model, phys.qpos,
                                             phys.qvel, a)),
        "reward": count(lambda: task.reward(phys, a)),
        "env_step": count(lambda: venv.step(states, a)),
    }
    buf = ReplayBuffer(num_envs=2, episode_len=5, capacity=20,
                       image_size=84, action_size=env.action_size,
                       batch_size=8, device="cpu")
    r = buf.add_reset(buf.init(), obs[:2])
    for _ in range(5):
        r = buf.add(r, a[:2], torch.zeros(2), obs[:2])
    for algo in ("sac", "sgsac"):
        cfg = Config(algorithm=algo, eval_mode="none", device="cpu",
                     batch_size=8).finalize()
        kw = {"overlay_pool": synth_images(4)} if algo == "sgsac" else {}
        agent = (SGSAC if algo == "sgsac" else SAC)(
            env.obs_shape, (env.action_size,), cfg, device="cpu", **kw)
        st = agent.init_state(0)
        agent.update(st, r, buf)  # first call: lazy set-up out of the count
        # st.step is now 1 (odd: critic only), then 2 (even: all steps)
        out[f"{algo}_update"] = count(lambda: agent.update(st, r, buf))
        out[f"{algo}_update_even"] = count(lambda: agent.update(st, r, buf))
        if algo == "sgsac":
            batch = agent.sample_batch(buf, r, st, {})
            out["sgsac_mask"] = count(
                lambda: agent.update_context(st, batch, {}))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
