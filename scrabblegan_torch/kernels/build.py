"""Build the port's CUDA kernels at first use and load them with ctypes.

`load_library()` compiles every `scrabblegan_torch/csrc/*.cu` with nvcc for
sm_90a (one nvcc per source, in parallel) and links them into one shared
library with a plain C interface, under
`build/scrabblegan_torch/` at the root of the checkout, named by a hash of the
sources, the headers (`csrc/*.cuh`) and the flags, so an edit rebuilds and an
unchanged tree reuses the library. It needs no PyTorch headers, so a build takes seconds. A missing
nvcc or a failed build raises; nothing but the repository's sources is built
or loaded.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "scrabblegan_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, /usr/local/cuda or the PATH; raises if absent."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
                       "and the PATH): the CUDA kernels cannot be built")


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.attention_fwd.argtypes = [p, p, p, p, i, i, i, ll, ll, ll, i, i, i, i, p]
    lib.attention_fwd.restype = i
    lib.attention_bwd.argtypes = [p] * 12 + [i, i, i, ll, ll, ll, ll, i, i, i, i, i, i, p]
    lib.attention_bwd.restype = i
    lib.attention_bwd_floor.argtypes = [i, i, p]
    lib.attention_bwd_floor.restype = i
    for name in ("attention_bwd_parts", "attention_bwd_reg_parts"):
        getattr(lib, name).argtypes = [i]
        getattr(lib, name).restype = i
    lib.fused_block_fwd.argtypes = [p, p, p, p, p, p, i, i, i, ll, ll, ll, i, i, p]
    lib.fused_block_fwd.restype = i
    lib.down_pool_fwd.argtypes = [p, p, p, ll, ll, i, i, p]
    lib.down_pool_fwd.restype = i
    lib.down_pool_bwd.argtypes = [p, p, ll, ll, i, i, p]
    lib.down_pool_bwd.restype = i
    lib.down_pool_nhwc_fwd.argtypes = [p, p, p, ll, ll, ll, i, i, p]
    lib.down_pool_nhwc_fwd.restype = i
    lib.down_pool_nhwc_bwd.argtypes = [p, p, ll, ll, ll, i, i, p]
    lib.down_pool_nhwc_bwd.restype = i
    for name in ("attention_fwd_key_tile", "attention_fwd_key_chunk",
                 "attention_fwd_warp_queries", "attention_bwd_warps",
                 "attention_bwd_warp_rows", "attention_bwd_keys", "attention_bwd_query_tile",
                 "attention_bwd_stats_blocks_per_sm", "attention_bwd_grads_blocks_per_sm",
                 "fused_block_fwd_channels", "fused_block_fwd_key_tile"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i
    return lib


def _compile(nvcc: str, sources: list[Path], lib_path: Path) -> str:
    """One nvcc per source, all started together, then one link; returns the
    compilers' output. Raises if any step fails."""
    tag = f"{os.getpid()}.tmp"
    objs = [lib_path.with_name(f"{lib_path.stem}.{src.stem}.{tag}.o") for src in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    outs = [proc.communicate()[0] for proc in procs]  # wait for all before any raise
    log = []
    for src, proc, out in zip(sources, procs, outs):
        log.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name} ({proc.returncode}):\n{out[-4000:]}")
    tmp = lib_path.with_suffix(f".{tag}")
    link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True)
    log.append(f"== link\n{link.stdout}{link.stderr}")
    for obj in objs:
        obj.unlink()
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr[-4000:]}")
    os.replace(tmp, lib_path)  # atomic: a concurrent loader sees all or nothing
    return "\n".join(log)


@functools.cache
def load_library() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernels' shared library."""
    nvcc = find_nvcc()
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*sources, *CSRC.glob("*.cuh")]):  # a header's edit rebuilds too
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    lib_path = BUILD_DIR / f"libscrabblegan_kernels_{digest.hexdigest()[:16]}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        lib_path.with_suffix(".log").write_text(_compile(nvcc, sources, lib_path))
    return _declare(ctypes.CDLL(str(lib_path)))


def build_log() -> str:
    """The compiler's output (ptxas register and shared-memory use) of the
    library `load_library()` loaded."""
    lib = load_library()
    return Path(lib._name).with_suffix(".log").read_text()
