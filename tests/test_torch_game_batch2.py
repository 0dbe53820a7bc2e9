"""The app layer against the JAX package on the CPU with a batch of two
(tests/test_torch_game.py has a batch of one): the scripted session of
models/game_check.py on both GameApps, held as tests/torch_app_session.py
says, with the frames that show the world (in game, paused, the in-game
options); the splash, menu and level select come before a level loads,
so the batch does not reach them, and the batch-of-one file holds them.
Its own file, so that the JAX app's tick compiles for the second batch
size in another pytest worker."""

from __future__ import annotations

from tests.torch_app_session import check_session_matches_jax


def test_app_session_matches_jax_batch2(tmp_path):
    check_session_matches_jax(tmp_path, batch=2,
                              labels=("in_game", "paused", "options", "video_options_fov", "in_game_again"))
