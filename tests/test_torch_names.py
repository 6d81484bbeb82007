"""Name parity: every module of the JAX package has its counterpart in the
port, under the same path, with every public top-level name (and every
public member of a class both define), read by ``ast`` without importing
either package.  The only misses allowed are the listed ones, each with its
reason; the list may not go stale (each entry must still be a miss).  Port-only names are allowed.  Also the
configs the port re-declares (``configs/base.py``) keep the reference's
fields and defaults."""
import ast
import dataclasses
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1] / "src"
REF, PORT = ROOT / "repro", ROOT / "repro_torch"

# Reference modules with no counterpart (none: every module is ported)
MODULES_NOT_YET_PORTED: set = set()

# Names missing from a ported module, by module: only names that have no
# counterpart in torch, each with its reason
NAMES_NOT_YET_PORTED = {
    # never: the Pallas tile width of the TPU kernels (the CUDA kernels pick
    # their own tiles; likewise the block_d/interpret parameters, which are
    # not top-level names)
    "kernels/relay_mix.py": {"DEFAULT_BLOCK_D"},
    # never: the parser of HLO text, which torch does not produce (the port
    # counts the dispatched ops instead)
    "launch/hlo_cost.py": {"parse_computations", "build_def_shapes", "OpInfo"},
    # never: the collective count over HLO text, which torch does not
    # produce; and ``os``, which the reference assigns to at import
    # (``os.environ["XLA_FLAGS"]``, 512 placeholder XLA devices) and the
    # parity reader counts as a name: the port needs no placeholder devices
    "launch/dryrun.py": {"collective_bytes", "COLLECTIVE_RE", "SHAPE_RE", "os"},
    # never: ``os``, as in launch/dryrun.py
    "launch/attribute.py": {"os"},
}
MEMBERS_NOT_YET_PORTED: dict = {}

REF_MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


def _top_level(path: pathlib.Path, *, public: bool = True) -> set[str]:
    """Names a module defines at top level (def, class, assignment) and, in a
    package's ``__init__``, the names it imports (its re-exports)."""
    init = path.name == "__init__.py"
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            names |= {n.id for t in targets for n in ast.walk(t) if isinstance(n, ast.Name)}
        elif init and isinstance(node, ast.ImportFrom) and node.module != "__future__":
            names |= {a.asname or a.name for a in node.names}
    return {n for n in names if not (public and n.startswith("_"))}


def _class_members(path: pathlib.Path) -> dict[str, set[str]]:
    members = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ClassDef):
            names = set()
            for b in node.body:
                if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    names.add(b.name)
                elif isinstance(b, ast.AnnAssign) and isinstance(b.target, ast.Name):
                    names.add(b.target.id)
                elif isinstance(b, ast.Assign):
                    names |= {t.id for t in b.targets if isinstance(t, ast.Name)}
            members[node.name] = {n for n in names if not n.startswith("_")}
    return members


@pytest.mark.parametrize("module", REF_MODULES)
def test_port_has_the_reference_module_and_its_names(module):
    port = PORT / module
    if module in MODULES_NOT_YET_PORTED:
        assert not port.exists(), f"{module} is ported: take it off the list"
        return
    assert port.exists(), f"repro_torch/{module} is missing"
    ref_names, port_names = _top_level(REF / module), _top_level(port)
    allowed = NAMES_NOT_YET_PORTED.get(module, set())
    assert ref_names - port_names - allowed == set()
    # the list may not go stale: each entry is in the reference and missing
    assert allowed <= _top_level(REF / module, public=False) - _top_level(port, public=False)
    ref_members, port_members = _class_members(REF / module), _class_members(port)
    for cls in ref_members.keys() & port_members.keys():
        allowed = MEMBERS_NOT_YET_PORTED.get((module, cls), set())
        assert ref_members[cls] - port_members[cls] - allowed == set(), cls
        assert allowed <= ref_members[cls] - port_members[cls], cls


def test_exception_lists_name_reference_modules():
    assert MODULES_NOT_YET_PORTED <= set(REF_MODULES)
    assert {m for m, _ in MEMBERS_NOT_YET_PORTED} | set(NAMES_NOT_YET_PORTED) <= set(REF_MODULES)


@pytest.mark.parametrize("cls", ["FLConfig", "ShardingConfig", "RunConfig"])
def test_configs_keep_the_reference_fields_and_defaults(cls):
    from repro.configs import base as jax_base
    from repro_torch.configs import base

    def fields(c):
        return [(f.name, f.default) for f in dataclasses.fields(c)]

    assert fields(getattr(base, cls)) == fields(getattr(jax_base, cls))
    run = base.RunConfig(model=None, fl=base.FLConfig(), sharding=base.ShardingConfig())
    assert run.fl.n_clients == 16 and run.sharding.mode == "tp"


def test_resnet20_reduced_is_the_full_config():
    from repro_torch.configs import resnet20_cifar

    assert resnet20_cifar.reduced() is resnet20_cifar.CONFIG


def test_packages_reexport_like_the_reference():
    import repro_torch.core as core
    import repro_torch.data as data
    import repro_torch.fl as fl
    from repro_torch.fl.engine import run_rounds_loop
    from repro_torch.fl.simulator import FLSimulator

    assert core.aggregation.colrel_increment and core.relay.neighbor_support
    assert data.loader.FederatedLoader and data.synthetic and data.partition
    assert fl.FLSimulator is FLSimulator and fl.run_rounds_loop is run_rounds_loop
