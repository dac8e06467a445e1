"""Build and load the port's CUDA kernels: ``nvcc`` → shared library → ctypes.

Each source under ``kernels/csrc/`` has a plain C interface (pointers, sizes
and the stream as ``void*``; every entry returns ``cudaGetLastError()``), so
it compiles in seconds without PyTorch's headers. Libraries are built at
first use into ``<checkout>/build/kernels/`` (listed in ``.gitignore``),
named by a digest of the source and the flags, so an edited source is never
served from a stale library. `build` starts one ``nvcc`` per missing source,
all at once, and waits for all of them. Processes that start together (the
ranks of a sharded run) build once: `build` holds an exclusive lock on
``build/kernels/build.lock`` (``flock``, released when its holder exits,
however it exits), so the others wait for the libraries and build none.
Nothing is built on import.

The compiler is ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else
``/usr/local/cuda/bin/nvcc``. The target is ``sm_90a`` (Hopper).
`zeroed_scratch` keeps the int32 buffers that kernels merging their blocks
in one launch (ticket counters, accumulators) leave zeroed between calls;
`slice_plan` sizes the row-slice grids of the elementwise kernels.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {
    "magnitude_histogram": "magnitude_histogram.cu",
    "hybrid_compress": "hybrid_compress.cu",
    "recover": "recover.cu",
    "decode_attention": "decode_attention.cu",
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LOADED: dict = {}


def build_dir() -> Path:
    """``<checkout>/build/kernels`` — src/repro_torch/kernels is three levels
    below the checkout root."""
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built on the machine with the card")


def library_path(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return build_dir() / f"lib{name}-{digest[:16]}.so"


def build(names=None) -> float:
    """Compile every named kernel whose library is missing, one ``nvcc`` per
    source, all started together. Returns the seconds taken. Raises with
    the compiler's output if any build fails. The ptxas report (registers,
    shared memory, spills) is kept beside each library as ``<name>.log``."""
    names = list(SOURCES) if names is None else list(names)
    t0 = time.perf_counter()
    if all(library_path(n).exists() for n in names):
        return 0.0
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    with _build_lock(out_dir):
        # another process may have built them while this one waited
        todo = [n for n in names if not library_path(n).exists()]
        if todo:
            _compile(todo, out_dir)
    return time.perf_counter() - t0


@contextlib.contextmanager
def _build_lock(out_dir: Path):
    """An exclusive ``flock`` on ``out_dir/build.lock`` across processes."""
    with open(out_dir / "build.lock", "a+") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _compile(todo: list, out_dir: Path) -> None:
    """One ``nvcc`` per source in ``todo``, all at once."""
    exe = nvcc()
    procs = []
    for name in todo:
        final = library_path(name)
        tmp = final.with_name(f"{final.name}.{os.getpid()}.tmp")
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs.append((name, final, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed = []
    for name, final, tmp, proc in procs:
        log, _ = proc.communicate()
        (out_dir / f"{name}.log").write_bytes(log)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n"
                          + log.decode(errors="replace"))
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, final)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))


def build_log(name: str) -> str:
    """The compiler's report from the last build of ``name`` ('' if none)."""
    p = build_dir() / f"{name}.log"
    return p.read_text(errors="replace") if p.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, built first if missing."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _LOADED[name] = lib
        return lib


def stream_of(tensor) -> int:
    """Raw ``cudaStream_t`` of PyTorch's current stream on ``tensor``'s
    device — kernels launch there and never synchronise."""
    import torch
    return torch.cuda.current_stream(tensor.device).cuda_stream


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (launch plans
    size their grids from it)."""
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count


def slice_plan(rows: int, n: int, sm_count: int, blocks_per_sm: int,
               min_per_block: int, max_per_block: int | None = None
               ) -> tuple[int, int]:
    """(per_block, blocks_per_row) of a grid that cuts each of ``rows`` rows
    of n elements in slices of per_block elements (a multiple of 4: whole
    16-byte vectors), about ``blocks_per_sm`` blocks per SM over all rows,
    each slice at least ``min_per_block`` elements where n allows and at
    most ``max_per_block``."""
    want = max(1, min(-(-n // min_per_block),
                      -(-blocks_per_sm * sm_count // rows)))
    if max_per_block is not None:
        want = max(want, -(-n // max_per_block))
    per_block = -(-n // want)
    per_block = -(-per_block // 4) * 4
    return per_block, -(-n // per_block)


_ZEROED: dict = {}


def zeroed_scratch(name: str, device, n: int, stream: int = 0):
    """At least ``n`` int32 of scratch for kernel ``name``'s launches on
    ``stream`` of ``device``, zeroed once when allocated (or grown). The
    kernels that use it leave it zeroed, so no call pays a memset; one
    buffer per stream, so launches on two streams never share one."""
    import torch
    key = (name, device, stream)
    buf = _ZEROED.get(key)
    if buf is None or buf.numel() < n:
        size = max(n, 4096, 2 * buf.numel() if buf is not None else 0)
        buf = torch.zeros(size, dtype=torch.int32, device=device)
        _ZEROED[key] = buf
    return buf


def check_launch(code: int, name: str) -> None:
    """Raise if a C entry reported a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {code}")
