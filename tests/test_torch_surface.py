"""The port's package surface against the JAX package's: every public name
of parakeet_tpu is exported by parakeet_tpu_torch or on the port's explicit
list of names not ported, and that list holds nothing else."""

import pytest

import parakeet_tpu as R
import parakeet_tpu_torch as T


def test_every_reference_name_is_exported_or_listed():
    missing = sorted(set(R.__all__) - set(T.__all__))
    assert missing == sorted(T.NOT_PORTED)
    assert not set(T.NOT_PORTED) & set(T.__all__)
    assert len(set(T.NOT_PORTED)) == len(T.NOT_PORTED) == 4


@pytest.mark.parametrize("name", sorted(set(R.__all__) - set(T.NOT_PORTED)))
def test_exported_name_resolves(name):
    assert name in T.__all__
    assert getattr(T, name) is not None
    # a class or function keeps the reference's name (no alias of another)
    ref = getattr(R, name)
    if hasattr(ref, "__name__"):
        assert getattr(T, name).__name__ == ref.__name__


def test_all_is_exact():
    assert len(T.__all__) == len(set(T.__all__))
    for name in T.__all__:
        assert hasattr(T, name), name
    assert T.__version__ == R.__version__


def test_mesh_training_surface_matches_reference():
    """The mesh-training names (parallel/, train.make_sharded_trainer,
    train_loop, checkpoint): the reference's exports, each with the
    reference's parameters in its order (the port adds only `device`)."""
    import inspect

    import parakeet_tpu.parallel as RPAR
    import parakeet_tpu_torch.parallel as TPAR
    from parakeet_tpu import checkpoint as RCK
    from parakeet_tpu import train as RT
    from parakeet_tpu import train_loop as RL
    from parakeet_tpu.parallel import pipeline as RPP
    from parakeet_tpu_torch import checkpoint as TCK
    from parakeet_tpu_torch import train as TT
    from parakeet_tpu_torch import train_loop as TL
    from parakeet_tpu_torch.parallel import pipeline as TPP

    assert TPAR.__all__ == RPAR.__all__
    for name in RPAR.__all__:
        assert getattr(TPAR, name).__name__ == getattr(RPAR, name).__name__
    assert set(RPP.__all__) <= set(TPP.__all__)
    assert set(RL.__all__) <= set(TL.__all__) and set(RCK.__all__) <= set(TCK.__all__)
    for ref, port, name in ((RT, TT, "make_sharded_trainer"), (RPP, TPP, "make_pp_trainer"),
                            (RPP, TPP, "pipeline_encode"), (RPP, TPP, "split_layer_params"),
                            (RPP, TPP, "merge_layer_params"), (RL, TL, "run_training"),
                            (RL, TL, "place_train_state"), (RCK, TCK, "save_train_state"),
                            (RCK, TCK, "load_train_state")):
        want = list(inspect.signature(getattr(ref, name)).parameters)
        got = list(inspect.signature(getattr(port, name)).parameters)
        assert got[:len(want)] == want and set(got[len(want):]) <= {"device"}, name


# ─── every module of the reference against the port's module of the same path ──

import ast
import importlib
import inspect
import json
import shutil
import subprocess
import sys
import tomllib
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_KNOB = ("a TPU lowering knob, a process global that picks an XLA or Pallas form (ROADMAP "
         "'Deliberate departures'); FusedLayers() or the card's own numerics take its place")
# the reference's exported names that the port does not export, each with
# its reason; every one stands under ROADMAP's "Deliberate departures"
NOT_PORTED = {
    "parakeet_tpu": {name: _KNOB for name in ("set_conv_layout", "set_fused_attention", "set_fused_block2",
                                              "set_fused_ffn")},
    "parakeet_tpu.models.encoder": {
        "fused_kernels_active": _KNOB + " (it reads the globals)",
        "rel_shift": "the pad-reshape trick; the port's attention indexes the shifted entries instead",
        "set_conv_layout": _KNOB,
        "set_fused_subsample": _KNOB,
    },
    "parakeet_tpu.ops.layers": {
        "anchor_quantized_weights": "the decode loops convert quantized weights once a call (hoist_dequant)",
        "conv2d_nhwc": _KNOB + " (an NHWC lowering)",
        "conv_pref": _KNOB,
        "get_conv_accum_f32": _KNOB,
        "matmul_precision": _KNOB + " (Precision.HIGHEST; the port requires IEEE f32 instead)",
        "set_bf16_precision": _KNOB,
        "set_conv_accum_f32": _KNOB,
    },
    "parakeet_tpu.quantize": {"dequantize_int4_jnp": "the jnp form; the port's is dequantize_int4_torch"},
}
# modules of the reference with no counterpart of the same path
NOT_PORTED_MODULES = {
    **{f"parakeet_tpu.ops.pallas_{k}": "a Pallas TPU kernel; the port's ops/*.py over csrc/*.cu replace it"
       for k in ("attention", "block", "conv", "ffn", "frontend", "subsample")},
    "parakeet_tpu.ops.pallas_utils": "Pallas helpers; the kernels' numerics are in ops/kernel_numerics.py",
    "parakeet_tpu.tools.torch_ref": "the independent torch oracle, kept out so that it stays independent",
}
# parameters of the reference that the port leaves out (TPU knobs)
KNOB_PARAMS = {"xla_only", "act_sharding", "layout"}
# functions whose reference parameters are not the port's leading ones
PARAM_DEPARTURES = {
    "parakeet_tpu.parallel.mesh.batch_sharding": "returns this rank's slice of a batch, not a NamedSharding",
    "parakeet_tpu.parallel.batch_sharding": "the same function, re-exported",
    "parakeet_tpu.models.encoder.fastconformer_encode": "`fused` is the port's fifth positional",
}


def _reference_modules() -> list[str]:
    """Every module of parakeet_tpu whose source assigns __all__."""
    root = REPO / "parakeet_tpu"
    found = []
    for path in sorted(root.rglob("*.py")):
        tree = ast.parse(path.read_text())
        if any(isinstance(n, ast.Assign) and any(isinstance(t, ast.Name) and t.id == "__all__" for t in n.targets)
               for n in tree.body):
            parts = path.relative_to(REPO).with_suffix("").parts
            found.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return found


REFERENCE_MODULES = _reference_modules()


def _port_name(module: str) -> str:
    return "parakeet_tpu_torch" + module[len("parakeet_tpu"):]


@pytest.mark.parametrize("module", REFERENCE_MODULES)
def test_module_exports_every_reference_name_or_lists_it(module):
    ref = importlib.import_module(module)
    if module in NOT_PORTED_MODULES:
        with pytest.raises(ModuleNotFoundError):
            importlib.import_module(_port_name(module))
        return
    port = importlib.import_module(_port_name(module))
    listed = NOT_PORTED.get(module, {})
    assert sorted(set(ref.__all__) - set(port.__all__)) == sorted(listed)
    assert not set(listed) & set(port.__all__)
    for name in set(ref.__all__) - set(listed):
        got, want = getattr(port, name), getattr(ref, name)
        if inspect.isfunction(want) or inspect.isclass(want):
            assert got.__name__ == want.__name__, name


def test_not_ported_lists_hold_only_reference_names():
    assert set(NOT_PORTED) | set(NOT_PORTED_MODULES) <= set(REFERENCE_MODULES)
    for module, names in NOT_PORTED.items():
        assert set(names) <= set(importlib.import_module(module).__all__), module
    assert sorted(NOT_PORTED["parakeet_tpu"]) == sorted(T.NOT_PORTED)
    assert sum(map(len, NOT_PORTED.values())) == 16 and len(NOT_PORTED_MODULES) == 8


def _shared_callables(module: str):
    """(qualified name, reference callable, port callable) of every public
    function, and every public method (and __init__) of every class, that
    both modules export."""
    ref, port = importlib.import_module(module), importlib.import_module(_port_name(module))
    for name in ref.__all__:
        r, p = getattr(ref, name), getattr(port, name, None)
        if p is None or not callable(p):
            continue
        if inspect.isfunction(r):
            yield f"{module}.{name}", r, p
        elif inspect.isclass(r) and inspect.isclass(p):
            for attr, member in vars(r).items():
                if attr.startswith("_") and attr != "__init__":
                    continue
                if isinstance(member, (staticmethod, classmethod)) or inspect.isfunction(member):
                    if callable(getattr(p, attr, None)):
                        yield f"{module}.{name}.{attr}", getattr(r, attr), getattr(p, attr)


@pytest.mark.parametrize("module", [m for m in REFERENCE_MODULES if m not in NOT_PORTED_MODULES])
def test_shared_functions_take_the_reference_parameters_first(module):
    """The reference's parameters, TPU knobs left out, lead the port's in
    the reference's order; the port adds its own only after them."""
    for qual, r, p in _shared_callables(module):
        try:
            want = [n for n in inspect.signature(r).parameters if n not in KNOB_PARAMS]
            got = list(inspect.signature(p).parameters)
        except (TypeError, ValueError):  # a builtin or a C type without a signature
            continue
        if qual in PARAM_DEPARTURES:
            continue
        assert got[:len(want)] == want, f"{qual}: reference {want}, port {got}"


def test_parameter_departures_are_the_listed_ones():
    """Each listed departure still departs (the list holds nothing stale),
    and fastconformer_encode keeps the reference's parameters in order."""
    from parakeet_tpu.models import encoder as RE
    from parakeet_tpu_torch.models import encoder as TE

    quals = {qual for m in REFERENCE_MODULES if m not in NOT_PORTED_MODULES for qual, _, _ in _shared_callables(m)}
    assert set(PARAM_DEPARTURES) <= quals
    want = [n for n in inspect.signature(RE.fastconformer_encode).parameters if n not in KNOB_PARAMS]
    got = list(inspect.signature(TE.fastconformer_encode).parameters)
    assert [n for n in got if n in want] == want and got[4] == "fused"


@pytest.mark.parametrize("package", ["ops", "text", "audio", "decode", "io"])
def test_subpackage_imports_as_the_reference(package):
    ref = importlib.import_module(f"parakeet_tpu.{package}")
    code = (f"from parakeet_tpu_torch.{package} import {', '.join(ref.__all__)}\n"
            "import sys\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'parakeet_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO, check=True)
    assert out.stdout.strip() == "[]"


def test_console_scripts_name_the_port_beside_the_reference():
    scripts = tomllib.loads((REPO / "pyproject.toml").read_text())["project"]["scripts"]
    ref = {k: v for k, v in scripts.items() if v.startswith("parakeet_tpu.")}
    port = {k: v for k, v in scripts.items() if v.startswith("parakeet_tpu_torch.")}
    assert len(ref) == len(port) == 6 and len(scripts) == 12
    assert {k.replace("parakeet", "parakeet-torch", 1): v.replace("parakeet_tpu.", "parakeet_tpu_torch.", 1)
            for k, v in ref.items()} == port
    code = ("import importlib, json, sys\n"
            f"targets = {json.dumps(sorted(port.values()))}\n"
            "ok = [callable(getattr(importlib.import_module(t.split(':')[0]), t.split(':')[1])) for t in targets]\n"
            "print(json.dumps([ok, sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'parakeet_tpu'))]))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO, check=True)
    assert json.loads(out.stdout) == [[True] * 6, []]


def _imports(path: Path) -> set[str]:
    found = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            found |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            found.add(node.module.split(".")[0])
    return found


def test_no_port_module_imports_the_reference():
    files = sorted((REPO / "parakeet_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    bad = {str(f.relative_to(REPO)): sorted(_imports(f) & {"parakeet_tpu", "jax", "jaxlib", "optax"}) for f in files}
    assert {k: v for k, v in bad.items() if v} == {}


@pytest.mark.skipif(shutil.which("g++") is None, reason="g++ not present to build the host libraries")
def test_the_port_reads_nothing_of_the_reference_at_run_time(tmp_path):
    """In a fresh interpreter under an audit hook: import every module of
    the port, then build (g++, into an empty build directory) and load the
    native and FLAC libraries and the C API, and follow every kernel's
    includes. No file it opens, no library it loads and no compiler
    argument lies under parakeet_tpu/ or the root csrc/; every source it
    compiles lies under parakeet_tpu_torch/csrc/."""
    code = r'''
import importlib, json, os, pkgutil, sys
from pathlib import Path
seen, compiled = [], []
def hook(event, args):
    if event == "open" and isinstance(args[0], (str, bytes, os.PathLike)):
        seen.append(os.fsdecode(args[0]))
    elif event == "ctypes.dlopen" and args[0]:
        seen.append(os.fsdecode(args[0]))
    elif event == "subprocess.Popen":
        argv = [os.fsdecode(a) for a in args[1]]
        seen.extend(argv)
        compiled.extend(a for a in argv if a.endswith((".cpp", ".cu")))
sys.addaudithook(hook)
import parakeet_tpu_torch
for m in pkgutil.walk_packages(parakeet_tpu_torch.__path__, "parakeet_tpu_torch."):
    importlib.import_module(m.name)
from parakeet_tpu_torch import native
from parakeet_tpu_torch.audio import codecs
from parakeet_tpu_torch.ops import _build
_build.BUILD_DIR = Path(sys.argv[1])
assert native.available() and codecs.flac_available()
capi = _build.build_capi()
includes = [str(p) for cu in sorted(_build._CSRC.glob("*.cu")) for p in _build.sources(cu.stem)]
print(json.dumps({"seen": seen, "compiled": compiled, "includes": includes, "capi": capi is not None}))
'''
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], capture_output=True, text=True, cwd=REPO,
                         check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    port_csrc = (REPO / "parakeet_tpu_torch" / "csrc").resolve()
    assert len(got["compiled"]) == 2 + got["capi"] and len(got["includes"]) > 8
    assert all(Path(p).resolve().is_relative_to(port_csrc) for p in got["compiled"] + got["includes"])
    forbidden = [(REPO / "parakeet_tpu").resolve(), (REPO / "csrc").resolve()]
    touched = [p for p in got["seen"]
               if Path(p).is_absolute() and any(Path(p).resolve().is_relative_to(f) for f in forbidden)]
    assert touched == []
