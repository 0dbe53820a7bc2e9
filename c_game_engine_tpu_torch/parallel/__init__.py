from c_game_engine_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    shard_sim,
    sharded_rollout,
)
