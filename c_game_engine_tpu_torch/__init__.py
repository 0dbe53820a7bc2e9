"""c_game_engine_tpu_torch — PyTorch + CUDA port of c_game_engine_tpu.

The JAX package `c_game_engine_tpu` stays the reference; this package runs
the same headless batched tick (`models/sim.py`: `reset_batch` + `rollout`)
with PyTorch on an NVIDIA H100, its three hot kernels
(`ops/capsule_resolve`, `ops/ray_tris`, `ops/body_contacts`) written by
hand in CUDA C++ under `csrc/`. The layout and module names follow the JAX
package so each counterpart is easy to find. It never imports jax or
c_game_engine_tpu.

Maps are compiled by the port's own compiler from `.gmap` binaries and
editor-JSON sources (`compiler/compile.py::compile_map`, through the cache
of `compiler/cache.py`), or loaded from plain numpy/JSON files
(`core/state.py::load_map`; the committed `maps/*` are built by
`tests/torch_export_map.py` with the JAX compiler).
"""

import torch

__version__ = "0.1.0"

TARGET_TPS = 60  # reference: engine/include/engine/Engine.h:12, physics/Physics.h:12
MIN_TPS = 10  # reference: engine/include/engine/physics/Physics.h:14
GRAVITY = -9.81  # reference: engine/include/engine/physics/Physics.h:34
COLLISION_SUBSTEPS = 2  # reference: engine/src/physics/MapPhysics.c:107
MAX_CONTACT_CONSTRAINTS = 16384  # reference: engine/include/engine/physics/Physics.h:16

# Geometry stays in full f32. TF32 keeps ~3 decimal digits and would round
# the one-hot contractions of the signal handlers (the Precision.HIGHEST
# einsum of actors/handlers.py:124 in the JAX package) and any projection
# constant the way bf16 did on the TPU (PARITY.md #19: 1.000005 rounded to
# 1 emptied every frame). Matmul TF32 is already off by default; cuDNN's
# is on by default, so both are set here explicitly.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
