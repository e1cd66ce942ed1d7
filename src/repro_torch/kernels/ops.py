"""Kernel routing, the build, and the launch counters.

Each public function here routes by the device of the tensors it is
given: a CPU tensor goes to the plain PyTorch version in
:mod:`repro_torch.kernels.ref`, a CUDA tensor to the hand-written CUDA
kernel (``csrc/``), and anything else raises. There is no fallback from
the kernel to the plain version. The reference's shape routing (a long
or ragged sequence takes the chunked plain attention) lives in
``models.attention.attn_apply``, where the attention route is chosen.

The kernels are built at first use with ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, loaded with ``ctypes``. The
sources compile in parallel; the library is keyed by the sources'
content, under ``build/repro_torch`` at the repository root. Each CUDA
wrapper adds one to its launch counter (:func:`launches`) right after
its kernel launched, and nowhere else; a kernel with more than one
instantiation also counts which one ran (:func:`variants`). The counters
are guarded by a lock: the campaign executor's workers launch from
several threads at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.bloom_probe import bloom_probe_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.policy_vm import policy_vm_cuda
from repro_torch.kernels.ref_scan import ref_scan_cuda
from repro_torch.kernels.rowclone_copy import rowclone_copy_cuda
from repro_torch.kernels.selective_scan import selective_scan_cuda
from repro_torch.kernels.slot_scan import (ScanParams, slot_scan_cuda,
                                          slot_scan_window_cuda)

KERNELS = ("bloom_probe", "policy_vm", "slot_scan", "slot_scan_window",
           "ref_scan", "flash_attention", "rowclone_copy", "selective_scan")
_CSRC = Path(__file__).resolve().parent / "csrc"
_SOURCES = ("bloom_probe.cu", "policy_vm.cu", "slot_scan.cu", "ref_scan.cu",
            "flash_attention.cu", "rowclone_copy.cu", "selective_scan.cu")
_HEADERS = ("bloom_hash.cuh", "common.cuh", "policy_vm.cuh", "threefry.cuh")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

MAX_KV_KERNEL = 8192   # attn_apply sends longer key sequences to plain attention
_LAUNCHES = {name: 0 for name in KERNELS}
_VARIANTS: dict = {}
_COUNT_LOCK = threading.Lock()   # the counters; workers launch concurrently
_LOCK = threading.Lock()         # the library's build and load
_LIB: Optional[ctypes.CDLL] = None
BUILD_INFO: dict = {}
# the library's on-disk build: a hit is a library loaded from disk, a miss
# an nvcc build in this process (the counterpart of the reference's
# persistent compile cache)
_PERSISTENT = {"hits": 0, "misses": 0}


def launches() -> dict:
    """Kernel launches counted since the last :func:`reset_launches`."""
    with _COUNT_LOCK:
        return dict(_LAUNCHES)


def variants() -> dict:
    """Launches by ``"kernel/instantiation"`` since the last
    :func:`reset_launches` (kernels with one instantiation are absent)."""
    with _COUNT_LOCK:
        return dict(_VARIANTS)


def reset_launches() -> None:
    with _COUNT_LOCK:
        for name in _LAUNCHES:
            _LAUNCHES[name] = 0
        _VARIANTS.clear()


def check_launch(name: str, err: int, variant: Optional[str] = None) -> None:
    """Raise on a refused launch (``cudaGetLastError`` != 0), else count
    it, under ``variant`` too when the kernel has several."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    with _COUNT_LOCK:
        _LAUNCHES[name] += 1
        if variant is not None:
            key = f"{name}/{variant}"
            _VARIANTS[key] = _VARIANTS.get(key, 0) + 1


def ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def aligned16(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """``t``, or a copy of it where its data is not 16-byte aligned (for
    kernels that load it 16 bytes at a time)."""
    return t if t is None or t.data_ptr() % 16 == 0 else t.clone()


def persistent_stats() -> dict:
    """``{'hits', 'misses', 'dir'}`` of the library's on-disk build: hits
    count libraries loaded from ``BUILD_DIR``, misses nvcc builds in this
    process; all zero, with ``dir`` None, until a library was built or
    loaded (always on the CPU)."""
    with _COUNT_LOCK:
        built = _PERSISTENT["hits"] + _PERSISTENT["misses"]
        return {**_PERSISTENT, "dir": str(BUILD_DIR) if built else None}


def stream_handle(device) -> int:
    """The raw ``cudaStream_t`` of ``device``'s current stream, read
    without building a ``torch.cuda.Stream`` (a twentieth of the host time
    of ``torch.cuda.current_stream``: ``benchmarks/wrapper_host_cost.py``)."""
    index = device.index
    return torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device() if index is None else index)


def _nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cands.append(os.path.join(root, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda); "
                       "the CUDA kernels cannot be built")


def build() -> Path:
    """Compile the kernels into one shared library (once per content
    digest) and return its path. Records timings and the compiler's
    register / spill report in :data:`BUILD_INFO`."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for name in _SOURCES + _HEADERS:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    out_dir = BUILD_DIR
    lib_path = out_dir / f"libreprotorch_{h.hexdigest()[:16]}.so"
    if lib_path.exists():
        BUILD_INFO.update(path=str(lib_path), seconds=0.0, cached=True)
        with _COUNT_LOCK:
            _PERSISTENT["hits"] += 1
        return lib_path
    nvcc = _nvcc()
    work = out_dir / f"work-{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for src in _SOURCES:
        obj = work / (src[:-3] + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(_CSRC / src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {src}\n{out}")
        if proc.returncode != 0:
            failed.append(src)
    log = "\n".join(logs)
    (work / "build.log").write_text(log)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{log}")
    tmp = work / lib_path.name
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *[str(o) for _, o, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
    os.replace(tmp, lib_path)
    shutil.copy(work / "build.log", out_dir / "build.log")
    shutil.rmtree(work, ignore_errors=True)
    with _COUNT_LOCK:
        _PERSISTENT["misses"] += 1
    BUILD_INFO.update(
        path=str(lib_path), seconds=time.perf_counter() - t0, cached=False,
        ptxas=[ln.strip() for ln in log.splitlines()
               if "registers" in ln or "spill" in ln])
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            vp, i = ctypes.c_void_p, ctypes.c_int
            lib.bloom_probe_launch.argtypes = [vp, i, i, vp, vp, i, i, i, i,
                                               vp]
            ll = ctypes.c_longlong
            lib.policy_vm_launch.argtypes = [vp, i, i, vp, i, vp, vp]
            lib.policy_vm_wide_launch.argtypes = [vp, i, i, vp, i, vp, vp,
                                                  vp]
            lib.policy_vm_wide_scratch_ints.argtypes = [i, i]
            lib.policy_vm_wide_scratch_ints.restype = ll
            lib.slot_scan_launch.argtypes = [ctypes.POINTER(i)] + [vp] * 14
            lib.slot_scan_wide_launch.argtypes = [ctypes.POINTER(i)] \
                + [vp] * 15
            lib.slot_scan_wide_scratch_ints.argtypes = [ctypes.POINTER(i)]
            lib.slot_scan_wide_scratch_ints.restype = ll
            lib.slot_scan_window_launch.argtypes = [
                ctypes.POINTER(i), i, ctypes.POINTER(vp), i, vp, vp]
            lib.slot_scan_num_params.argtypes = []
            lib.ref_scan_launch.argtypes = [ctypes.POINTER(i)] + [vp] * 6 \
                + [i] * 4 + [vp] * 9
            lib.ref_scan_row_ints.argtypes = [i, i, i]
            lib.ref_scan_row_ints.restype = ll
            lib.ref_scan_num_params.argtypes = []
            lib.flash_attention_launch.argtypes = [vp] * 4 + [i] * 7 + [
                ctypes.c_float, vp]
            lib.rowclone_copy_launch.argtypes = [vp, vp, ll, ll, ll, vp]
            lib.selective_scan_launch.argtypes = [vp] * 9 + [i] * 4 + [vp]
            for fn in (lib.bloom_probe_launch, lib.policy_vm_launch,
                       lib.policy_vm_wide_launch, lib.slot_scan_launch,
                       lib.slot_scan_wide_launch,
                       lib.slot_scan_window_launch, lib.slot_scan_num_params,
                       lib.ref_scan_launch, lib.ref_scan_num_params,
                       lib.flash_attention_launch, lib.rowclone_copy_launch,
                       lib.selective_scan_launch):
                fn.restype = i
            for src, n in (("slot_scan.cu", lib.slot_scan_num_params()),
                           ("ref_scan.cu", lib.ref_scan_num_params())):
                if n != len(ScanParams.__dataclass_fields__):
                    raise RuntimeError(
                        f"{src} takes {n} params, ScanParams has "
                        f"{len(ScanParams.__dataclass_fields__)}")
            _LIB = lib
        return _LIB


def _route(name: str, t: torch.Tensor) -> str:
    if t.device.type in ("cpu", "cuda"):
        return t.device.type
    raise ValueError(f"{name}: no kernel or plain version for device "
                     f"{t.device}")


def bloom_probe(words: torch.Tensor, keys: torch.Tensor, k: int,
                m_bits: int) -> torch.Tensor:
    """words int32 ``[Bw, W]``, keys int32 ``[B, N]`` -> int8 ``[B, N]``."""
    if _route("bloom_probe", keys) == "cpu":
        return ref.bloom_probe_ref(words, keys, k, m_bits)
    return bloom_probe_cuda(words, keys, k, m_bits)


def policy_vm(tables: torch.Tensor, envm: torch.Tensor) -> torch.Tensor:
    """tables ``[P, L + 1, 4]`` x env ``[N_LOADS, Q]`` -> ``[P, 3, Q]``."""
    if _route("policy_vm", tables) == "cpu":
        return ref.policy_vm_ref(tables, envm)
    return policy_vm_cuda(tables, envm)


def slot_scan(kind, bank, row, delta, dep, weak, tables, costs,
              p: ScanParams) -> dict:
    """One batch group's whole slot scan (see ``kernels/slot_scan.py``)."""
    if _route("slot_scan", kind) == "cpu":
        return ref.slot_scan_ref(kind, bank, row, delta, dep, weak, tables,
                                 costs, p)
    return slot_scan_cuda(kind, bank, row, delta, dep, weak, tables, costs, p)


def slot_scan_window(st, kind, bank, row, delta, dep, weak, tables, costs,
                     p: ScanParams, final: bool):
    """One stream window's slot scan on the shifted window state ``st``
    (an ``EmulatorState``): returns the state after the window."""
    if _route("slot_scan_window", kind) == "cpu":
        return ref.slot_scan_window_ref(st, kind, bank, row, delta, dep,
                                        weak, tables, costs, p, final)
    return slot_scan_window_cuda(st, kind, bank, row, delta, dep, weak,
                                 tables, costs, p, final)


def ref_scan(kind, bank, row, delta, dep, bloom, tables, costs,
             p: ScanParams) -> dict:
    """One batch group through the reference engine's slot scan (see
    ``kernels/ref_scan.py``); ``bloom`` None or (words, k, m_bits)."""
    if _route("ref_scan", kind) == "cpu":
        return ref.ref_scan_ref(kind, bank, row, delta, dep, bloom, tables,
                                costs, p)
    return ref_scan_cuda(kind, bank, row, delta, dep, bloom, tables, costs, p)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q ``[B, S, H, hd]``, k / v ``[B, S, KV, hd]`` -> ``[B, S, H, hd]``.

    Groups the q heads by kv head (``B * KV * G`` rows, as the reference
    wrapper does) for :func:`flash_attention_bhsd`."""
    B, Sq, H, hd = q.shape
    KV, Sk = k.shape[2], k.shape[1]
    qr = q.permute(0, 2, 1, 3).reshape(B * H, Sq, hd).contiguous()
    kr = k.permute(0, 2, 1, 3).reshape(B * KV, Sk, hd).contiguous()
    vr = v.permute(0, 2, 1, 3).reshape(B * KV, Sk, hd).contiguous()
    o = flash_attention_bhsd(qr, kr, vr, causal)
    return o.reshape(B, H, Sq, hd).permute(0, 2, 1, 3)


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True) -> torch.Tensor:
    """q ``[BHq, Sq, hd]``, k / v ``[BHkv, Sk, hd]`` -> ``[BHq, Sq, hd]``.

    Forward only, on both routes, as the reference's Pallas kernel (it has
    no backward): under autograd with an input that requires grad it
    raises, where the kernel's output would silently carry no gradient.
    Training takes the plain attention (``attn_apply(use_flash=False)``)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "flash_attention has no backward (nor has the reference's "
            "kernel); train through the plain attention, use_flash=False")
    if _route("flash_attention", q) == "cpu":
        return ref.flash_attention_ref(q, k, v, causal)
    return flash_attention_cuda(q, k, v, causal)


def selective_scan(u, dt, Bm, Cm, A, D, h0):
    """Mamba's selective scan over a whole sequence: u, dt ``[B, S, di]``,
    Bm / Cm ``[B, S, N]``, A ``[di, N]``, D ``[di]``, h0 ``[B, di, N]``,
    float32 -> (y ``[B, S, di]``, hT ``[B, di, N]``).

    Forward only, on both routes, as the flash kernel: under autograd
    with an input that requires grad it raises (the kernel's output would
    carry no gradient). Training scans through ``models.mamba``'s plain
    chunked route (``mamba_seq(use_kernel=False)``)."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (u, dt, Bm, Cm, A, D, h0)):
        raise NotImplementedError(
            "selective_scan has no backward; train through the plain "
            "chunked scan, mamba_seq(use_kernel=False)")
    if _route("selective_scan", u) == "cpu":
        return ref.selective_scan_ref(u, dt, Bm, Cm, A, D, h0)
    return selective_scan_cuda(u, dt, Bm, Cm, A, D, h0)


def rowclone_copy(x: torch.Tensor,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A copy of ``x`` ``[R, C]`` (any dtype), into ``out`` when given."""
    if _route("rowclone_copy", x) == "cpu":
        return ref.rowclone_copy_ref(x, out)
    return rowclone_copy_cuda(x, out)
