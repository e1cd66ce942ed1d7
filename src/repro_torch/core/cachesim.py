"""Set-associative LLC model: turns CPU address streams into DRAM traces.

The modeled system (Jetson-Nano-flavored) has a 512 KiB 8-way LLC with
64 B lines (the paper's EasyDRAM config). Vectorized-enough numpy LRU;
traces here are bounded (<= a few hundred K accesses) so this is fast.
"""
from __future__ import annotations

import numpy as np


class LLC:
    def __init__(self, size_bytes=512 * 1024, ways=8, line=64):
        self.line = line
        self.ways = ways
        self.sets = size_bytes // (ways * line)
        self.tags = np.full((self.sets, ways), -1, np.int64)
        self.lru = np.zeros((self.sets, ways), np.int64)
        self.dirty = np.zeros((self.sets, ways), bool)
        self.tick = 0

    def access(self, addr: int, is_write: bool):
        """Returns (miss, writeback_addr or -1)."""
        self.tick += 1
        lineaddr = addr // self.line
        s = lineaddr % self.sets
        tag = lineaddr // self.sets
        row = self.tags[s]
        hit = np.nonzero(row == tag)[0]
        if hit.size:
            w = hit[0]
            self.lru[s, w] = self.tick
            if is_write:
                self.dirty[s, w] = True
            return False, -1
        w = int(np.argmin(self.lru[s]))
        wb = -1
        if self.tags[s, w] >= 0 and self.dirty[s, w]:
            wb = int((self.tags[s, w] * self.sets + s) * self.line)
        self.tags[s, w] = tag
        self.lru[s, w] = self.tick
        self.dirty[s, w] = is_write
        return True, wb

    def flush_line(self, addr: int):
        """CLFLUSH: returns writeback addr or -1; invalidates the line."""
        lineaddr = addr // self.line
        s = lineaddr % self.sets
        tag = lineaddr // self.sets
        hit = np.nonzero(self.tags[s] == tag)[0]
        if not hit.size:
            return -1
        w = hit[0]
        wb = int(addr) if self.dirty[s, w] else -1
        self.tags[s, w] = -1
        self.dirty[s, w] = False
        return wb


def filter_stream(addrs, writes, llc: LLC = None):
    """Run an address stream through the LLC; return DRAM-level accesses
    as (addr, is_write) arrays (misses + writebacks)."""
    llc = llc or LLC()
    out_a, out_w = [], []
    for a, w in zip(addrs, writes):
        miss, wb = llc.access(int(a), bool(w))
        if wb >= 0:
            out_a.append(wb)
            out_w.append(True)
        if miss:
            out_a.append(int(a))
            out_w.append(False)
    return np.asarray(out_a, np.int64), np.asarray(out_w, bool), llc
