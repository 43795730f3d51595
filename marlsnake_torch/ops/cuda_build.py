"""Building the port's CUDA sources into shared libraries with nvcc.

Each source under ``csrc/`` is compiled on its own (sm_90a, ``-fmad=false``)
into ``build/marlsnake_torch/`` at the repository root, as a library with a
plain C interface that its wrapper loads with ctypes. The file name carries a
hash of the source and the flags, so an edited source is rebuilt and a built
one is reused. ``build`` starts one nvcc for each source not built yet, all at
once, and waits for all of them.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from typing import Callable, List, Tuple

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), 'build',
                         'marlsnake_torch')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-O3',
              '-fmad=false', '-std=c++17', '-shared', '-Xcompiler', '-fPIC',
              '-Xptxas', '-v')


def nvcc() -> str:
    cuda_home = os.environ.get('CUDA_HOME') or '/usr/local/cuda'
    path = os.path.join(cuda_home, 'bin', 'nvcc')
    if os.path.exists(path):
        return path
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError('nvcc not found: the CUDA kernels are built '
                           'with the CUDA toolkit on the GPU machine')
    return found


def library_path(source: str) -> str:
    """Where the library of ``source`` is (or will be) built."""
    with open(source, 'rb') as fp:
        digest = hashlib.sha256(fp.read() + ' '.join(NVCC_FLAGS).encode())
    name = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f'{name}_{digest.hexdigest()[:16]}.so')


def build(*sources: str) -> List[Tuple[str, str]]:
    """Compile every source whose library is not built yet, one nvcc each,
    all started together; returns (library path, compiler output, which
    lists registers and shared memory; '' where it was built before) for
    each source, in order."""
    paths = [library_path(s) for s in sources]
    jobs = {}
    for source, path in zip(sources, paths):
        if os.path.exists(path) or path in jobs:
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f'{path}.{os.getpid()}.tmp'
        proc = subprocess.Popen([nvcc(), *NVCC_FLAGS, '-o', tmp, source],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[path] = (proc, tmp)
    logs, failed = {}, []
    for path, (proc, tmp) in jobs.items():
        logs[path] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f'nvcc failed ({proc.returncode}) for '
                          f'{os.path.basename(path)}:\n{logs[path]}')
        else:
            os.replace(tmp, path)
    if failed:
        raise RuntimeError('\n'.join(failed))
    return [(path, logs.get(path, '')) for path in paths]


def on_current_stream(index: int, call: Callable[[int], int]) -> int:
    """``call(stream)`` on PyTorch's current stream of device ``index`` (its
    raw handle, as the launchers take it; ``torch.cuda.current_stream()``
    would build a Stream object on every call), with that device
    current."""
    if torch.cuda.current_device() != index:
        with torch.cuda.device(index):
            return call(torch._C._cuda_getCurrentRawStream(index))
    return call(torch._C._cuda_getCurrentRawStream(index))


def raise_on(rc: int, what: str, error_string: Callable[[int], bytes]
             ) -> None:
    """Raise where a launcher returned the error code ``rc``: ``what``
    names the launch, ``error_string`` is its library's message entry."""
    if rc != 0:
        raise RuntimeError(f'{what} kernel launch failed: '
                           f'{error_string(rc).decode()}')
