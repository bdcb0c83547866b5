"""Write a BWA/GSAlign five-file index's text files (.pac/.ann/.amb and a
.bwt header) for a packed genome, in the layout that the index importers
(gsalign_tpu/index/bwa_import.py and its port) read: bns_dump
(src/BWT_Index/bntseq.c:59-89), the 2-bit .pac (bntseq.c:192-205) and the
.bwt header of bwt_restore_bwt (src/bwt_index.cpp:102-121). The C
reference's own index build is not needed."""

from __future__ import annotations

import struct

import numpy as np


def write_bwa_files(prefix: str, genome, primary: int, l2) -> None:
    """prefix.pac/.ann/.amb of `genome` (a packing.Genome of either
    package) and prefix.bwt holding only the header: primary, then
    L2[1..4] (five little-endian int64)."""
    codes = np.asarray(genome.codes_fwd, dtype=np.uint8)
    l_pac = int(codes.shape[0])
    padded = np.zeros(-(-l_pac // 4) * 4, dtype=np.uint8)
    padded[:l_pac] = codes
    quads = padded.reshape(-1, 4)
    packed = (quads[:, 0] << 6) | (quads[:, 1] << 4) | (quads[:, 2] << 2) \
        | quads[:, 3]
    with open(prefix + ".pac", "wb") as fh:
        fh.write(packed.astype(np.uint8).tobytes())
        if l_pac % 4 == 0:
            fh.write(b"\x00")
        fh.write(bytes([l_pac % 4]))
    holes = list(genome.holes)
    with open(prefix + ".ann", "w") as fh:
        fh.write(f"{l_pac} {len(genome.names)} {genome.seed}\n")
        for i, name in enumerate(genome.names):
            off, ln = int(genome.offsets[i]), int(genome.lengths[i])
            n_amb = sum(1 for h in holes if off <= h.offset < off + ln)
            fh.write(f"{i} {name} (null)\n{off} {ln} {n_amb}\n")
    with open(prefix + ".amb", "w") as fh:
        fh.write(f"{l_pac} {len(genome.names)} {len(holes)}\n")
        for h in holes:
            fh.write(f"{h.offset} {h.length} {chr(h.amb)}\n")
    l2 = [int(v) for v in np.asarray(l2)[1:5]]
    with open(prefix + ".bwt", "wb") as fh:
        fh.write(struct.pack("<5q", int(primary), *l2))
