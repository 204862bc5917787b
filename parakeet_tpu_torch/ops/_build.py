"""Build the port's CUDA kernels on first use and load them with ctypes.

Each source under parakeet_tpu_torch/csrc/ compiles with nvcc into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), placed in build/parakeet_tpu_torch/ beside the package and named
by a hash of the source, of every header it includes from csrc/ and of
the compiler flags, so an edited source or header rebuilds and concurrent
processes never load a half-written file. `build` holds no lock: several
libraries can build at once from separate threads.

`build_host` does the same with g++ for a host C++ source of the same
csrc/ (flac_decoder.cpp, the FLAC decoder; parakeet_native.cpp, the native
audio library), into the same directory; `build_capi` builds the port's
flat C API (csrc/parakeet_capi.cpp) against the running interpreter's
libpython. Every source the port compiles lies under
parakeet_tpu_torch/csrc/.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import sys
import sysconfig
import tempfile
import threading
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "parakeet_tpu_torch"
# -Xptxas -v: ptxas reports each kernel's registers, shared memory and
# spills on stderr, which `build` keeps in BUILD_LOG (there is no ncu on the
# card's machine)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
GXX_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC")
_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)

# the dtype argument every kernel entry takes: 0 = float32, 1 = bfloat16
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# the H100's dynamic shared memory per block (bytes) and its SM count, for
# the launch plans that the wrappers compute and pass to the kernels
SHARED_MEMORY_LIMIT = 232_448
SM_COUNT = 132

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
# the compiler's stderr of each library built by this process, by name
BUILD_LOG: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): cannot build the CUDA kernels")


def sources(name: str) -> list[Path]:
    """csrc/<name>.cu and every header it includes with #include "…",
    followed transitively, in the order first reached."""
    found: list[Path] = []
    stack = [_CSRC / f"{name}.cu"]
    while stack:
        path = stack.pop()
        if path in found:
            continue
        found.append(path)
        for inc in reversed(_INCLUDE.findall(path.read_bytes())):
            stack.append((path.parent / inc.decode()).resolve())
    return found


def source_digest(name: str) -> str:
    """Hash of csrc/<name>.cu, the headers it includes and the nvcc flags."""
    h = hashlib.sha256()
    for path in sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    """Where the library of csrc/<name>.cu at its present contents lives."""
    return BUILD_DIR / f"lib{name}-{source_digest(name)}.so"


def _compile(compiler: list[str], src: Path, lib: Path, link: tuple[str, ...] = ()) -> Path:
    """Compile `src` into `lib` through a temporary file; `link` follows
    the source on the command line. The compiler's stderr goes to
    BUILD_LOG under the source's stem."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [*compiler, "-o", tmp, str(src), *link]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{Path(cmd[0]).name} failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}")
        BUILD_LOG[src.stem] = proc.stderr
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def build(name: str) -> Path:
    """Compile csrc/<name>.cu (if not built yet) and return the library path."""
    lib = library_path(name)
    if lib.is_file():
        return lib
    return _compile([_nvcc(), *NVCC_FLAGS], _CSRC / f"{name}.cu", lib)


def host_library_path(name: str) -> Path:
    """Where the library of csrc/<name>.cpp lives, named by a hash of the
    source and the g++ flags."""
    src = _CSRC / f"{name}.cpp"
    h = hashlib.sha256(src.name.encode() + b"\0" + src.read_bytes() + b"\0" + " ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_host(name: str) -> Path:
    """Compile the standalone host source csrc/<name>.cpp with g++ (if not
    built yet) and return the library path."""
    lib = host_library_path(name)
    if lib.is_file():
        return lib
    return _compile([_gxx(f"csrc/{name}.cpp"), *GXX_FLAGS], _CSRC / f"{name}.cpp", lib)


def _gxx(what: str) -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found on PATH: cannot build {what}")
    return gxx


def _capi_flags() -> tuple[tuple[str, ...], tuple[str, ...]] | None:
    """(compile flags, link flags) that embed the running interpreter, as
    the reference's C API build takes them; None when this Python has no
    shared libpython (Py_ENABLE_SHARED != 1)."""
    if sysconfig.get_config_var("Py_ENABLE_SHARED") != 1:
        return None
    libdir = sysconfig.get_config_var("LIBDIR")
    pylib = f"python{sysconfig.get_config_var('VERSION')}{sys.abiflags}"
    return ((*GXX_FLAGS, f"-I{sysconfig.get_paths()['include']}", f"-I{_CSRC}"),
            (f"-L{libdir}", f"-l{pylib}", f"-Wl,-rpath,{libdir}"))


def build_capi() -> Path | None:
    """Compile the port's flat C API, csrc/parakeet_capi.cpp (header
    csrc/parakeet.h), into build/parakeet_tpu_torch/libparakeet_c-<hash>.so
    (if not built yet), the hash over both files and the flags; None when
    the interpreter cannot be embedded (no shared libpython)."""
    flags = _capi_flags()
    if flags is None:
        return None
    h = hashlib.sha256()
    for path in (_CSRC / "parakeet_capi.cpp", _CSRC / "parakeet.h"):
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update(" ".join(flags[0] + flags[1]).encode())
    lib = BUILD_DIR / f"libparakeet_c-{h.hexdigest()[:16]}.so"
    if lib.is_file():
        return lib
    return _compile([_gxx("the C API"), *flags[0]], _CSRC / "parakeet_capi.cpp", lib, flags[1])


def load(name: str) -> ctypes.CDLL:
    """Build if needed and load csrc/<name>.cu's library (once per process)."""
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(build(name)))
        return _loaded[name]


def ptr(t: torch.Tensor | None):
    """A tensor's device address for a ctypes call (None for no tensor)."""
    return None if t is None else t.data_ptr()


def stream(device: torch.device) -> int:
    """The current CUDA stream of `device`, as the kernels' last argument."""
    return torch.cuda.current_stream(device).cuda_stream


def check_rc(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def refuse_grad(name: str, *tensors) -> None:
    """Raise when grad mode is on and a float tensor among `tensors`
    requires grad: a kernel writes a fresh buffer with no backward, so its
    output would cut the autograd graph without a word. K1 differentiates
    through its autograd Function (ops/rel_attention.py), whose forward
    launches with grad mode off."""
    if torch.is_grad_enabled() and any(isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the kernel has no backward; it cannot run on inputs that require grad "
                           "(train with FusedLayers(), whose attention kernel K1 differentiates)")


__all__ = ["BUILD_DIR", "BUILD_LOG", "NVCC_FLAGS", "GXX_FLAGS", "DTYPE_CODE", "SHARED_MEMORY_LIMIT", "SM_COUNT", "sources",
           "source_digest", "library_path", "build", "host_library_path", "build_host", "build_capi",
           "load", "ptr", "stream", "check_rc", "refuse_grad"]
