"""Bloom filter over weak DRAM rows (RAIDR-style, Sec. 8.2 of the paper).

Host-built (numpy) from the characterization pass and probed for every
request the engine serves. Keys are weak rows, so a false positive only
means a weak-timing row gets *nominal* tRCD — never an unsafe reduced
access. :func:`bloom_probe_torch` is the plain probe; the ``bloom_probe``
kernel in ``repro_torch.kernels`` is its CUDA twin.

Words travel to torch as int32 tensors holding the uint32 bit patterns
(:func:`words_tensor`); the plain probe works in int64 masked to 32 bits
because torch has no right shift on uint32.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

_MULS = np.array([0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F, 0x165667B1,
                  0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2D], np.uint32)
_FINAL_MUL = 0x2B2AE3D5
_M32 = 0xFFFFFFFF


def _mix(x: np.ndarray, mul: int) -> np.ndarray:
    x = x.astype(np.uint32)
    x ^= x >> np.uint32(16)
    x = (x * np.uint32(mul)) & np.uint32(0xFFFFFFFF)
    x ^= x >> np.uint32(13)
    x = (x * np.uint32(_FINAL_MUL)) & np.uint32(0xFFFFFFFF)
    x ^= x >> np.uint32(16)
    return x


@dataclasses.dataclass
class BloomFilter:
    bits: np.ndarray       # uint32 words, len = m_bits // 32
    m_bits: int
    k: int

    @staticmethod
    def build(keys: np.ndarray, m_bits: int = 1 << 20, k: int = 4) -> "BloomFilter":
        if m_bits % 32 or m_bits & (m_bits - 1):
            raise ValueError(f"m_bits must be a power of two >= 32, got {m_bits}")
        words = np.zeros(m_bits // 32, np.uint32)
        keys = np.asarray(keys, np.uint32)
        for i in range(k):
            idx = _mix(keys, int(_MULS[i])) & np.uint32(m_bits - 1)
            np.bitwise_or.at(words, idx >> np.uint32(5),
                             np.uint32(1) << (idx & np.uint32(31)))
        return BloomFilter(bits=words, m_bits=m_bits, k=k)

    def contains(self, keys: np.ndarray) -> np.ndarray:
        keys = np.asarray(keys, np.uint32)
        out = np.ones(keys.shape, bool)
        for i in range(self.k):
            idx = _mix(keys, int(_MULS[i])) & np.uint32(self.m_bits - 1)
            bit = (self.bits[idx >> np.uint32(5)] >> (idx & np.uint32(31))) & np.uint32(1)
            out &= bit.astype(bool)
        return out

    def false_positive_rate(self, probes: np.ndarray, truth: np.ndarray) -> float:
        pos = self.contains(probes)
        fp = pos & ~truth
        denom = max(int((~truth).sum()), 1)
        return float(fp.sum()) / denom


def words_tensor(bits, device=None) -> torch.Tensor:
    """uint32 words -> int32 tensor of the same bits."""
    arr = np.ascontiguousarray(np.asarray(bits, np.uint32)).view(np.int32)
    return torch.from_numpy(arr.copy()).to(device)


def bloom_probe_torch(words: torch.Tensor, m_bits: int, k: int,
                      keys: torch.Tensor) -> torch.Tensor:
    """Plain probe. ``words``: ``[W]`` or ``[Bw, W]`` int32 bit patterns
    (``Bw`` 1 or the batch of ``keys``); ``keys``: ``[N]`` or ``[B, N]``
    integers taken mod 2^32 -> bool of ``keys``' shape."""
    w = words.to(torch.int64) & _M32
    x0 = keys.to(torch.int64) & _M32
    squeeze = x0.dim() == 1
    if squeeze:
        x0 = x0.unsqueeze(0)
    if w.dim() == 1:
        w = w.unsqueeze(0)
    w = w.expand(x0.shape[0], w.shape[-1])
    out = torch.ones(x0.shape, dtype=torch.bool, device=x0.device)
    for i in range(k):
        x = x0
        x = x ^ (x >> 16)
        x = (x * int(_MULS[i])) & _M32
        x = x ^ (x >> 13)
        x = (x * _FINAL_MUL) & _M32
        x = x ^ (x >> 16)
        idx = x & (m_bits - 1)
        bit = (torch.gather(w, 1, idx >> 5) >> (idx & 31)) & 1
        out = out & (bit == 1)
    return out.squeeze(0) if squeeze else out
