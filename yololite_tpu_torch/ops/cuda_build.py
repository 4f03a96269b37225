"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Each `csrc/<name>.cu` has a plain C interface and compiles on its own into
`csrc/build/lib<name>-<hash>.so` (the hash covers the source, the shared
headers `csrc/*.cuh` and the flags, so an edited source or header is rebuilt). The build happens at first use, on the
machine with the card; nothing here runs when the module is imported.
`build(names)` starts one nvcc per source, all at once, and waits for all.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

from yololite_tpu_torch.utils import ROOT

CSRC = ROOT / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then /usr/local/cuda/bin, then PATH."""
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put the CUDA toolkit's bin/ on PATH")
    return found


def library_path(name: str) -> Path:
    text = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every named source that has no up-to-date library, in parallel.

    Writes nvcc's output (ptxas register and shared-memory use) beside each
    library as `.log`. Raises with the compiler's output if a build fails.
    """
    names = list(names)
    out = {n: library_path(n) for n in names}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in names:
        if out[n].exists():
            continue
        tmp = out[n].with_name(f"{out[n].name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp)
    failed = []
    for n, (p, tmp) in procs.items():
        log, _ = p.communicate()
        out[n].with_suffix(".log").write_text(log)
        if p.returncode != 0:
            failed.append(f"{n}.cu (nvcc exit {p.returncode}):\n{log}")
            continue
        os.replace(tmp, out[n])
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(build([name])[name]))
        return _loaded[name]
