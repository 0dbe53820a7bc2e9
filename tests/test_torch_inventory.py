"""The port does all the JAX package does: an inventory of both packages,
read with `ast` (neither is imported).

Every top-level function and class of c_game_engine_tpu/ has a counterpart
of the same name at the top level of the port's module of the same path
(defined there, or imported into it), or a row in COUNTERPARTS saying
where its work is done and why it has no same-named twin. Every public
JAX function's parameters appear in its counterpart, in the JAX order; a
counterpart may add `device`, and the extra parameters in EXTRA_PARAMS.

Below the top level:
  * every method, static method and property of a JAX class is a method
    of the port's class of the same name (followed through imports), a
    public one with the JAX parameters as above;
  * the JAX class's dataclass fields are fields of the port's class, in
    the JAX order (the port may add fields), with the same defaults;
  * every module-level UPPER_CASE name of a JAX module (private ones
    too) is bound at the same path in the port, or has a row in
    CONSTANT_ROWS; where both values are literals (a tuple or list of
    literals, also inside np/jnp.array(...)) they are equal, and any other
    pair of differing expressions has a row in VALUE_ROWS;
  * the default of every public parameter of a JAX function or method is
    the port's default of that parameter (a port constant's name counts as
    its literal value), or the difference has a row in DEFAULT_ROWS.
"""

from __future__ import annotations

import ast
import re
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
        "utils/checkpoint.py::_write", "the one host writer (an .npz, no orbax, no pickle): save_checkpoint calls it "
        "in one process, and in process 0 of a group with the gathered state"),
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
    ("models/game.py", "GameApp.__init__"): (
        {"synthetic_assets", "sound_dir", "search_paths"},
        "the synthetic HUD, UI and sound stand-ins for absent assets, and compile_map's search paths"),
}

# (JAX module, UPPER_CASE name) -> (where the port keeps it, why the name is
# not bound at the same path)
CONSTANT_ROWS = {
    ("actors/signals.py", "_OUTPUT_PTYPE"): (
        "actors/signals.py::_output_ptype", "a tensor built once per device: a module-level tensor lives on one device"),
    ("render/debug_draw.py", "_HEX"): (
        "render/debug_draw.py::_hex", "the capsule's ring directions, a tuple made a tensor once per device"),
    ("native.py", "_ROOT"): (
        "native.py::library_path", "the port builds its own csrc/cge_native.cpp: SOURCE and BUILD_DIR replace the "
        "repo root and its native/ directory"),
    ("native.py", "_SO"): (
        "native.py::library_path", "the library's name carries a hash of the compiler flags and the source, under "
        "build/torch_native/"),
}

# (JAX module, UPPER_CASE name) -> why the port's value differs
VALUE_ROWS = {
    ("compiler/cache.py", "CACHE_DIR"): (
        "the port's own cache, .cache/torch_maps, overridden by CGE_TORCH_MAP_CACHE_DIR: the two packages store "
        "different files (.npz/.json entries, not a pickled tree) and must not read each other's"),
    ("compiler/cache.py", "_FINGERPRINT_GLOBS"): (
        "the same globs over the port's package: a change to the port's compiler invalidates the port's cache"),
    ("compiler/models.py", "DEFAULT_SEARCH_PATHS"): (
        "the JAX package names the reference checkout's absolute asset directories; the port looks in assets/game "
        "and assets/engine at the repo root"),
    ("ops/raster_tiles_big.py", "SUB"): (
        "CGE_BIG_SUB is a VMEM tuning knob of the TPU kernel, and the frame does not depend on it; K5's subchunk "
        "is the compile-time 64 of csrc/raster_tiles_big.cu, so the port reads no environment variable"),
    ("render/debug_draw.py", "_CORNERS"): (
        "the same 8 corners in the same order, a tuple of floats made a tensor once per device"),
}

# (JAX module, function, "Class.method" or dataclass "Class", parameter or
# field) -> why the port's default differs
DEFAULT_ROWS = {
    ("render/textures.py", "build_atlas", "blocked_dtype"): (
        "jnp.bfloat16 -> torch.bfloat16: the same dtype in the port's library"),
    ("utils/config.py", "RunConfig", "map"): (
        "arena, the port's committed map: the JAX default is the reference checkout's test.gmap, which is not in "
        "this repository"),
    ("models/game.py", "GameApp.__init__", "map_dir"): (
        "the port's committed maps (models/sim.py::MAPS): the JAX default is the reference checkout's map "
        "directory, which is not in this repository"),
}


_CONST = re.compile(r"^_?[A-Z][A-Z0-9_]*$")


class _Module:
    """What the checks read of one module: classes (methods as
    ast.FunctionDef by name; fields as (name, default node or None), in
    order), functions (ast.FunctionDef by name), UPPER_CASE constants
    (name -> value node, None where unpacked from a non-tuple), `from X
    import Y` bindings (name -> (X, level, Y)), and every name bound at the
    top level (definitions, imports, assignments)."""

    def __init__(self, path: Path):
        self.path = path
        self.classes, self.functions, self.constants, self.imports = {}, {}, {}, {}
        self.bound = set()
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, ast.ClassDef):
                methods, fields = {}, []
                for b in node.body:
                    if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        methods[b.name] = b
                    elif isinstance(b, ast.AnnAssign) and isinstance(b.target, ast.Name):
                        fields.append((b.target.id, b.value))
                self.classes[node.name] = (methods, fields)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions[node.name] = node
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                for t in node.targets if isinstance(node, ast.Assign) else [node.target]:
                    if isinstance(t, ast.Name):
                        self.bound.add(t.id)
                        if _CONST.match(t.id):
                            self.constants[t.id] = node.value
                    elif isinstance(t, ast.Tuple):
                        vals = node.value.elts if isinstance(node.value, ast.Tuple) else [None] * len(t.elts)
                        for e, v in zip(t.elts, vals):
                            if isinstance(e, ast.Name):
                                self.bound.add(e.id)
                                if _CONST.match(e.id):
                                    self.constants[e.id] = v
            elif isinstance(node, (ast.Import, ast.ImportFrom)):
                for al in node.names:
                    self.bound.add((al.asname or al.name).split(".")[0])
                    if isinstance(node, ast.ImportFrom):
                        self.imports[al.asname or al.name] = (node.module, node.level, al.name)
        self.bound |= set(self.classes) | set(self.functions)

    def source_of(self, name):
        """The port module an imported `name` comes from, and its name
        there; None for a name not imported from the port's package."""
        if name not in self.imports:
            return None
        module, level, orig = self.imports[name]
        if level:
            base = self.path.parent
            for _ in range(level - 1):
                base = base.parent
            target = base.joinpath(*(module or "").split("."))
        elif module and module.split(".")[0] == PORT.name:
            target = PORT.joinpath(*module.split(".")[1:])
        else:
            return None
        for cand in (target.with_suffix(".py"), target / "__init__.py"):
            if cand.is_file():
                return _module(cand), orig
        return None

    def resolve(self, kind, name):
        """The class or constant `name` of this module, followed through
        imports: (found, value); found False where it is neither defined
        nor imported from the port."""
        table = self.classes if kind == "class" else self.constants
        if name in table:
            return True, table[name]
        src = self.source_of(name)
        return src[0].resolve(kind, src[1]) if src else (False, None)


_MODULES = {}


def _module(path: Path) -> _Module:
    if path not in _MODULES:
        _MODULES[path] = _Module(path)
    return _MODULES[path]


def _literal(node):
    """The value of a literal node as nested tuples (a list is a tuple; the
    first argument of np/jnp.array or asarray is read through), or a
    sentinel where the node is not a literal."""
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) and node.args and (
            node.func.attr in ("array", "asarray")):
        node = node.args[0]
    try:
        value = ast.literal_eval(node)
    except (ValueError, TypeError, SyntaxError, MemoryError, RecursionError):
        return _NOT_LITERAL

    def tup(v):
        return tuple(tup(x) for x in v) if isinstance(v, (list, tuple)) else v

    return tup(value)


_NOT_LITERAL = object()


def _same_value(jax_node, port_node, jax_module, port_module):
    """Whether two value nodes are equal: as literals of the same type
    where both read as literals (a module constant's name reads as its
    value), else as source text."""
    def value(node, module):
        if isinstance(node, ast.Name):
            found, v = module.resolve("constant", node.id)
            if found and v is not None:
                node = v
        return _literal(node)

    a, b = value(jax_node, jax_module), value(port_node, port_module)
    if a is not _NOT_LITERAL and b is not _NOT_LITERAL:
        return a == b and type(a) is type(b)
    return ast.unparse(jax_node) == ast.unparse(port_node)


def _defaults(fn):
    """{parameter: default node} of a function definition."""
    a = fn.args
    pos = a.posonlyargs + a.args
    out = dict(zip([p.arg for p in pos[len(pos) - len(a.defaults):]], a.defaults))
    out.update({p.arg: d for p, d in zip(a.kwonlyargs, a.kw_defaults) if d is not None})
    return out


def _params(fn):
    a = fn.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]


def _field_default(node):
    """A dataclass field's default node: the `default=` of a field(...)
    call, a marker for a default_factory, the node itself otherwise."""
    if isinstance(node, ast.Call) and isinstance(node.func, (ast.Attribute, ast.Name)) and (
            getattr(node.func, "attr", getattr(node.func, "id", None)) == "field"):
        kw = {k.arg: k.value for k in node.keywords}
        if "default" in kw:
            return kw["default"]
        if "default_factory" in kw:
            return ast.Constant("<default_factory>")
        return None
    return node


def _default_mismatches(module, name, jax_fn, port_fn, port_module):
    jax_module = _module(JAX / module)
    """The public parameters whose JAX default the port's function does not
    share (a parameter the port lacks is the parameter check's concern)."""
    port_defaults = _defaults(port_fn)
    bad = []
    for p, node in _defaults(jax_fn).items():
        if p.startswith("_") or p not in _params(port_fn) or (module, name, p) in DEFAULT_ROWS:
            continue
        if p not in port_defaults or not _same_value(node, port_defaults[p], jax_module, port_module):
            bad.append(f"{name}({p}={ast.unparse(node)})")
    return bad


def _top_level(path: Path):
    """({function or class name: parameter names, None for a class}, every
    name bound at the top level)."""
    m = _module(path)
    return {**{n: _params(f) for n, f in m.functions.items()}, **{n: None for n in m.classes}}, m.bound


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
        cls, _, method = key[1].partition(".")
        if method:
            assert method in _module(JAX / key[0]).classes[cls][0], key
        else:
            assert key[1] in _top_level(JAX / key[0])[0], key
    for key, (target, reason) in CONSTANT_ROWS.items():
        assert key[1] in _module(JAX / key[0]).constants and reason, key
        assert key[1] not in _top_level(PORT / key[0])[1], f"{key} is bound in the port now: drop its row"
        _port_function(target)
    for key, reason in VALUE_ROWS.items():
        jax, port = _module(JAX / key[0]), _module(PORT / key[0])
        assert key[1] in jax.constants and reason, key
        found, value = port.resolve("constant", key[1])
        assert found and not _same_value(jax.constants[key[1]], value, jax, port), f"{key}: values agree: drop its row"
    for (module, name, param), reason in DEFAULT_ROWS.items():
        jax = _module(JAX / module)
        cls, _, method = name.partition(".")
        if method:
            fn = jax.classes[cls][0][method]
            assert param in _defaults(fn) and reason, (module, name, param)
        elif name in jax.classes:
            assert param in dict(jax.classes[name][1]) and reason, (module, name, param)
        else:
            assert param in _defaults(jax.functions[name]) and reason, (module, name, param)


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


@pytest.mark.parametrize("module", _jax_modules())
def test_every_jax_constant_is_in_the_port(module):
    jax = _module(JAX / module)
    port_path = PORT / module
    assert port_path.is_file(), module
    port = _module(port_path)
    _, port_bound = _top_level(port_path)
    missing, differ = [], []
    for name, node in jax.constants.items():
        if (module, name) in CONSTANT_ROWS:
            continue
        if name not in port_bound:
            missing.append(name)
            continue
        found, value = port.resolve("constant", name)
        if (module, name) in VALUE_ROWS or not found or node is None or value is None:
            continue
        if not _same_value(node, value, jax, port):
            differ.append(f"{name}: {ast.unparse(node)} != {ast.unparse(value)}")
    assert not missing, f"{module}: the port lacks the constants {missing}"
    assert not differ, f"{module}: values differ: {differ}"


@pytest.mark.parametrize("module", _jax_modules())
def test_every_jax_class_has_its_methods_and_fields(module):
    jax = _module(JAX / module)
    port = _module(PORT / module)
    problems = []
    for cls, (methods, fields) in jax.classes.items():
        found, port_cls = port.resolve("class", cls)
        if not found:
            problems.append(f"{cls}: no port class")
            continue
        port_methods, port_fields = port_cls
        missing = [m for m in methods if m not in port_methods]
        if missing:
            problems.append(f"{cls} lacks the methods {missing}")
        for m, fn in methods.items():
            if m in port_methods and not m.startswith("_") or m == "__init__" and m in port_methods:
                _check_params((module, f"{cls}.{m}"), _params(fn), _params(port_methods[m]))
        names = [f for f, _ in port_fields]
        it = iter(names)
        if not all(f in it for f, _ in fields):
            problems.append(f"{cls}: fields {[f for f, _ in fields]} not in that order in {names}")
        port_defaults = dict(port_fields)
        for f, node in fields:
            if f not in port_defaults or (module, cls, f) in DEFAULT_ROWS:
                continue
            a, b = _field_default(node), _field_default(port_defaults[f])
            if (a is None) != (b is None) or a is not None and not _same_value(a, b, jax, port):
                problems.append(f"{cls}.{f}: default {ast.unparse(node) if node else None} != "
                                f"{ast.unparse(port_defaults[f]) if port_defaults[f] else None}")
    assert not problems, f"{module}: {problems}"


@pytest.mark.parametrize("module", _jax_modules())
def test_every_public_default_is_the_jax_one(module):
    jax = _module(JAX / module)
    port = _module(PORT / module)
    bad = []
    for name, fn in jax.functions.items():
        key = (module, name)
        if key in COUNTERPARTS:
            target = COUNTERPARTS[key][0]
            if name.startswith("_") or target.startswith("csrc/"):
                continue
            target_module, target_name = target.split("::")
            other = _module(PORT / target_module)
            bad += _default_mismatches(module, name, fn, other.functions[target_name], other)
        elif name in port.functions:
            bad += _default_mismatches(module, name, fn, port.functions[name], port)
    for cls, (methods, _) in jax.classes.items():
        found, port_cls = port.resolve("class", cls)
        for m, fn in methods.items():
            if found and m in port_cls[0]:
                bad += _default_mismatches(module, f"{cls}.{m}", fn, port_cls[0][m], port)
    assert not bad, f"{module}: defaults differ from the JAX ones: {bad}"


# what makes a JAX function multi-process: a call of these in its body
MULTIPROCESS_CALLS = ({"process_count", "process_index"}, "multihost_utils")
DISTRIBUTED = PORT / "parallel" / "distributed.py"


def _multiprocess_functions():
    """(JAX module, function) of every top-level JAX function whose body
    calls jax.process_count, jax.process_index or multihost_utils."""
    attrs, name = MULTIPROCESS_CALLS
    found = []
    for module in _jax_modules():
        for fn_name, fn in _module(JAX / module).functions.items():
            if any(isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name) and n.value.id == "jax"
                   and n.attr in attrs or isinstance(n, ast.Name) and n.id == name for n in ast.walk(fn)):
                found.append((module, fn_name))
    return found


def _imports_distributed(path: Path, node) -> bool:
    """Whether an import node of the module at `path` binds
    parallel/distributed.py or a name of it."""
    if not isinstance(node, ast.ImportFrom):
        return False
    if node.level:
        base = path.parent
        for _ in range(node.level - 1):
            base = base.parent
        target = base.joinpath(*(node.module or "").split("."))
    elif node.module and node.module.split(".")[0] == PORT.name:
        target = PORT.joinpath(*node.module.split(".")[1:])
    else:
        return False
    return target.with_suffix(".py") == DISTRIBUTED or any(
        target / f"{al.name}.py" == DISTRIBUTED for al in node.names)


def _reaches_distributed(path: Path, fn_name: str, seen=()) -> bool:
    """Whether the port function `fn_name` of the module at `path` uses a
    name bound to parallel/distributed.py, directly or through a function
    of its module it calls."""
    m = _module(path)
    fn = m.functions[fn_name]
    tree = ast.parse(path.read_text())
    bound = set()
    for node in tree.body + list(ast.walk(fn)):
        if _imports_distributed(path, node):
            bound |= {al.asname or al.name for al in node.names}
    used = {n.id for n in ast.walk(fn) if isinstance(n, ast.Name)}
    if used & bound:
        return True
    return any(_reaches_distributed(path, other, (*seen, fn_name))
               for other in used & set(m.functions) if other not in seen and other != fn_name)


def test_multiprocess_functions_reach_the_process_group():
    """Every JAX function that acts on the multi-process case has a
    counterpart that reaches the port's process group
    (parallel/distributed.py): a name match cannot see a missing branch."""
    found = _multiprocess_functions()
    assert ("utils/checkpoint.py", "save_checkpoint") in found, found
    missing = []
    for module, name in found:
        target = COUNTERPARTS.get((module, name), (f"{module}::{name}",))[0]
        t_module, t_name = target.split("::")
        if not _reaches_distributed(PORT / t_module, t_name):
            missing.append(f"{module}::{name} -> {target}")
    assert not missing, f"these counterparts never reach parallel/distributed.py: {missing}"
