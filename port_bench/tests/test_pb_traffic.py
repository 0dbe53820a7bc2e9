"""The traffic generator and the observation."""

import json

import numpy as np
import pytest
import torch

from harness.observe import Observer, observation
from harness.spec import BENCH_DIR, load_cell
from harness.traffic import ACTION_DIM, BUTTONS, Pool, draws

MIXES = ("agent_random", "agent_random_pixels", "stream_random")


def small(mix, envs=64):
    """traffic/<mix>.json at `envs` envs."""
    return dict(json.loads((BENCH_DIR / "traffic" / f"{mix}.json").read_text()), envs=envs)


@pytest.mark.parametrize("mix", MIXES)
def test_draws_are_the_seeds(mix):
    m = small(mix)
    a, b, c = draws(m, 2**31 + 5), draws(m, 2**31 + 5), draws(m, 2**31 + 6)
    assert a.shape == (m["episodes"], -(-m["episode_ticks"] // m["action_repeat"]), m["envs"], ACTION_DIM)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)
    # every seed the same streams in each episode, dealt to the envs in another order
    for e in range(m["episodes"]):
        assert not np.array_equal(a[e], c[e])
        key = lambda x: sorted(map(bytes, np.ascontiguousarray(x.transpose(1, 0, 2))))
        assert key(a[e]) == key(c[e])


def test_draws_follow_the_mix():
    m = small("agent_random", envs=4096)
    a = draws(m, 7)
    assert set(np.unique(a[..., 0:2])) == {-1.0, 0.0, 1.0}
    assert np.abs(a[..., 2]).max() <= m["yaw_per_tick"] and np.abs(a[..., 3]).max() <= m["pitch_per_tick"]
    for i, name in enumerate(BUTTONS):
        share = a[..., 4 + i].mean()
        p = m["buttons"].get(name, 0.0)
        assert abs(share - p) < 0.01, (name, share, p)
    # every env its own actions
    assert not np.array_equal(a[:, :, 0], a[:, :, 1])


def test_button_order_is_the_ports():
    from c_game_engine_tpu_torch.core.actions import ACTION_DIM as PORT_DIM
    from c_game_engine_tpu_torch.core.actions import Button

    assert BUTTONS == tuple(b.name for b in sorted(Button, key=int))
    assert ACTION_DIM == PORT_DIM


def test_pool_repeats_each_draw():
    m = small("stream_random", envs=16)
    pool = Pool(m, 11, torch.device("cpu"))
    s = pool.stream(m["episodes"] + 1)  # episodes cycle
    assert s.shape == (m["episode_ticks"], 16, ACTION_DIM)
    for t in range(m["episode_ticks"]):
        assert torch.equal(s[t], pool.tick(1, t))
        assert torch.equal(pool.tick(1, t), pool.tick(1, t - t % m["action_repeat"]))


def test_observation_flattens_the_named_leaves():
    from c_game_engine_tpu_torch.models.sim import load_named_map, reset_batch

    cmap = load_named_map("arena_bodies", "cpu")
    st = reset_batch(cmap, 3)
    names = load_cell("bodies_agent_4096").traffic["observe"]
    obs = Observer(names)(st)
    n_act = st.actors.pos.shape[1]
    assert obs.shape == (3, 14 + 7 * n_act) and obs.dtype == torch.float32
    assert torch.equal(obs[:, 0:3], st.player.pos)
    assert torch.equal(obs[:, 8], st.player.on_ground.float())
    assert torch.equal(obs[:, 14:14 + 3 * n_act], st.actors.pos.reshape(3, -1))
    assert torch.equal(obs, observation(st, names))
