"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its
700 W power limit; a card set lower runs slower under load, so every run
prints the card's power limit beside its numbers).

  HBM3            3.35e12 bytes/s
  host link       64e9 bytes/s, one direction of PCIe Gen5 x16
  integer ops     67e12 operations/s (the float32 rate outside the
                  tensor cores; no int32 rate is published)

A layer's least time is the largest of its HBM bytes, its host-link
bytes and its operations over these rates; `binding` names the one that
sets it.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
LINK_BYTES_PER_S = 64e9
OPS_PER_S = 67e12


def least_time(hbm_bytes: float, link_bytes: float, ops: float = 0.0):
    """(seconds, binding): the least time of hbm_bytes read or written
    in device memory, link_bytes across the host link and ops integer
    operations, and which of "hbm", "link", "ops" binds."""
    t = {"hbm": hbm_bytes / HBM_BYTES_PER_S,
         "link": link_bytes / LINK_BYTES_PER_S,
         "ops": ops / OPS_PER_S}
    binding = max(t, key=t.get)
    return t[binding], binding
