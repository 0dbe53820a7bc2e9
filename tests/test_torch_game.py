"""The app layer against the JAX package on the CPU: the scripted session
of models/game_check.py on the port's GameApp (models/game.py) and on the
JAX package's, at 128 x 128 with a batch of one (a batch of two:
tests/test_torch_game_batch2.py; the terminal viewer:
tests/test_torch_play.py), held as tests/torch_app_session.py says."""

from __future__ import annotations

from tests.torch_app_session import check_session_matches_jax


def test_app_session_matches_jax(tmp_path):
    check_session_matches_jax(tmp_path, batch=1)
