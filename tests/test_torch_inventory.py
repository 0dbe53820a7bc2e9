"""The port does all the JAX package does: an inventory of both packages,
read with `ast` (neither is imported).

Every top-level function and class of c_game_engine_tpu/ has a counterpart
of the same name at the top level of the port's module of the same path
(defined there, or imported into it), or a row in COUNTERPARTS saying
where its work is done and why it has no same-named twin. Every public
JAX function's parameters appear in its counterpart, in the JAX order; a
counterpart may add `device`, and the extra parameters in EXTRA_PARAMS.
"""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX = ROOT / "c_game_engine_tpu"
PORT = ROOT / "c_game_engine_tpu_torch"

# (JAX module, name) -> (where the port does its work, why there is no
# same-named counterpart in the port's module of the same path). A target
# "csrc/<file>" is a hand-written CUDA source of the port; "<module>::<name>"
# a port function (held to the JAX parameters where the JAX name is public).
COUNTERPARTS = {
    # the Pallas kernels: wrappers and kernel bodies, each a CUDA source
    ("ops/capsule_resolve.py", "resolve_capsule_pallas"): (
        "csrc/capsule_resolve.cu", "K1, the TPU kernel; launched by ops/capsule_resolve.py::resolve_capsule"),
    ("ops/capsule_resolve.py", "_closest_on_tri"): (
        "csrc/contact_math.cuh", "K1's and K3's closest point on a triangle, a device function there"),
    ("ops/capsule_resolve.py", "_first_row"): (
        "csrc/capsule_resolve.cu", "K1's first-deepest row, an integer warp reduction there (K3's in body_contacts.cu)"),
    ("ops/capsule_resolve.py", "_chunk_best"): (
        "csrc/capsule_resolve.cu", "K1's per-chunk deepest contact, one warp lane a row there"),
    ("ops/ray_tris.py", "ray_tris_pallas"): (
        "csrc/ray_tris.cu", "K2, the TPU kernel; launched by ops/ray_tris.py::ray_tris"),
    ("ops/body_contacts.py", "body_contacts_pallas"): (
        "csrc/body_contacts.cu", "K3, the TPU kernel; launched by ops/body_contacts.py::body_contacts"),
    ("ops/raster_tiles.py", "raster_tiles_pallas"): (
        "csrc/raster_tiles.cu", "K4, the TPU kernel; launched by ops/raster_tiles.py::raster_tiles_binned"),
    ("ops/raster_tiles.py", "_grids"): (
        "csrc/raster_tiles.cu", "K4's per-tile pixel coordinate grids, thread indices there"),
    ("ops/raster_tiles_big.py", "_kernel_big"): (
        "csrc/raster_tiles_big.cu", "K5's kernel body; launched by ops/raster_tiles_big.py::raster_tiles_big"),
    # TPU dispatch and lowering, which the port has no use for
    ("physics/batched.py", "_use_pallas"): (
        "physics/batched.py::update_character_batched",
        "TPU dispatch: the port always takes the kernel formulation (K1, K2 on the card, their plain versions on "
        "the CPU); the XLA formulation is physics/batched.py::resolve_capsule_batched"),
    ("physics/batched.py", "_unroll_loops"): (
        "physics/bodies.py::step_bodies_batched", "TPU lowering: unrolls XLA loops on the TPU; PyTorch runs loops eagerly"),
    ("physics/batched.py", "_make_pallas_ctx"): (
        "physics/batched.py::_make_kernel_ctx", "K1's inputs; the triangle table is cached on the map (CompiledMap.tri16)"),
    ("physics/batched.py", "_einsum32"): (
        "physics/bodies.py::step_bodies_batched",
        "TPU lowering: pins XLA's matmul precision; the port's contractions are float32 products and sums (TF32 off)"),
    # renamed
    ("physics/geometry.py", "jax_one_hot"): ("physics/geometry.py::one_hot", "renamed: the port has no jax"),
    # moved to another module of the port
    ("physics/batched.py", "step_bodies_batched"): (
        "physics/bodies.py::step_bodies_batched", "the rigid-body step, with K3, is a module of its own in the port"),
    ("physics/batched.py", "_support_toward"): (
        "physics/bodies.py::_support_toward", "the rigid-body step's helper, moved with it"),
    # private helpers the port inlined
    ("core/state.py", "_empty_audio"): (
        "audio/mixer.py::empty_audio", "inlined: reset() calls empty_audio(device) directly"),
    ("utils/checkpoint.py", "_save_host"): (
        "utils/checkpoint.py::save_checkpoint", "inlined: one host writer (an .npz, no orbax, no pickle)"),
    ("ui/stack.py", "_text_len"): (
        "ui/stack.py::ui_process", "inlined: (text >= 0).sum per row, batched"),
    ("compiler/sectors.py", "_bbox_overlap"): (
        "compiler/sectors.py::compile_map_source", "inlined: its nested overlapping(si) tests every sector's box at once"),
    ("render/raster.py", "_render_env"): (
        "render/raster.py::_render_envs", "batched: one call renders every env instead of a vmapped single env"),
    ("compiler/cache.py", "_to_numpy"): (
        "core/state.py::map_to_numpy", "the cache writes .npz leaves (map_to_numpy, render/bundle.py::bundle_to_numpy), "
        "not a pickled tree"),
}

# (JAX module, name) -> parameters a counterpart adds beyond the JAX ones
# and `device`, and why
EXTRA_PARAMS = {
    ("actors/signals.py", "empty_fired"): ({"batch"}, "batched buffers, [B, N]"),
    ("core/state.py", "empty_events"): ({"batch_shape"}, "batched event queues"),
    ("models/sim.py", "make_sim"): ({"search_paths"}, "the asset search paths of compile_map"),
    ("parallel/mesh.py", "make_mesh"): ({"devices"}, "a mesh is a list of torch devices"),
}


def _top_level(path: Path):
    """({function or class name: parameter names, None for a class}, every
    name bound at the top level: definitions, imports, assignments)."""
    tree = ast.parse(path.read_text())
    defs, bound = {}, set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            a = node.args
            defs[node.name] = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
        elif isinstance(node, ast.ClassDef):
            defs[node.name] = None
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            bound |= {(al.asname or al.name).split(".")[0] for al in node.names}
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            bound |= {t.id for t in targets if isinstance(t, ast.Name)}
    return defs, bound | set(defs)


def _jax_modules():
    return sorted(p.relative_to(JAX).as_posix() for p in JAX.rglob("*.py"))


def _port_function(target: str):
    module, name = target.split("::")
    defs, _ = _top_level(PORT / module)
    assert name in defs, f"{target} is not a function of the port"
    return defs[name]


def _check_params(key, jax_params, port_params):
    extra = EXTRA_PARAMS.get(key, (set(), ""))[0] | {"device"}
    assert set(port_params) - set(jax_params) <= extra, (key, port_params, jax_params)
    missing = [p for p in jax_params if p not in port_params]
    assert not missing, f"{key}: the port lacks the JAX parameters {missing}"
    assert [p for p in port_params if p in jax_params] == jax_params, f"{key}: parameters out of the JAX order"


def test_the_table_names_no_unported_work():
    for key, (target, reason) in COUNTERPARTS.items():
        assert (JAX / key[0]).is_file(), key
        defs, _ = _top_level(JAX / key[0])
        assert key[1] in defs, f"{key}: no such JAX function"
        assert "not ported" not in reason and reason, key
        if target.startswith("csrc/"):
            assert (PORT / target).is_file(), target
        else:
            _port_function(target)
    for key in EXTRA_PARAMS:
        assert key[1] in _top_level(JAX / key[0])[0], key


@pytest.mark.parametrize("module", _jax_modules())
def test_every_jax_function_has_a_counterpart(module):
    jax_defs, _ = _top_level(JAX / module)
    port_path = PORT / module
    port_defs, port_bound = _top_level(port_path) if port_path.is_file() else ({}, set())
    missing = []
    for name, params in jax_defs.items():
        key = (module, name)
        if key in COUNTERPARTS:
            target = COUNTERPARTS[key][0]
            assert name not in port_defs, f"{key} has a counterpart of its own name now: drop its row"
            if not name.startswith("_") and not target.startswith("csrc/") and params is not None:
                _check_params(key, params, _port_function(target))
            continue
        if name not in port_bound:
            missing.append(name)
            continue
        if params is not None and not name.startswith("_") and name in port_defs:
            assert port_defs[name] is not None, f"{key}: a function in JAX, a class in the port"
            _check_params(key, params, port_defs[name])
    assert not missing, f"{module}: no counterpart in the port for {missing}"


def test_every_jax_class_is_a_port_class():
    for module in _jax_modules():
        jax_defs, _ = _top_level(JAX / module)
        port_path = PORT / module
        port_defs, port_bound = _top_level(port_path) if port_path.is_file() else ({}, set())
        for name, params in jax_defs.items():
            if params is None:
                assert name in port_bound, (module, name)
