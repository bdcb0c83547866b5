"""Import a reference GSAlign/BWA five-file index (.pac/.ann/.amb/.bwt/.sa).

A user with existing GSAlign indexes can point this tool at the prefix and
get our device-layout index WITHOUT the original FASTA: the genome text is
reconstructed exactly the way the reference aligner does it —
`RestoreReferenceInfo` decodes the forward-only 2-bit .pac and mirrors the
reverse complement (src/bwt_index.cpp:193-264); ambiguous
bases stay as the random bases baked into the .pac at build time (the
reference never restores N from .amb into its in-RAM text, so neither do
we — alignments over such an index are byte-identical to the reference's).
The .ann/.amb text metadata supply the chromosome table and holes
(bns_restore_core, src/bwt_index.cpp:37-90; written by
bns_dump, src/BWT_Index/bntseq.c:59-89).

Our rank tables are then rebuilt from the text (build_fmindex): the
reference's interleaved-occ .bwt and every-32nd .sa sampling
(src/bwt_index.cpp:102-145) don't map onto the device union/order-3/comb
layout, and rebuilding is cheap next to shipping a FASTA around. The .bwt
header's primary/L2 values are cross-checked against the rebuilt index as
an integrity test when the file is present.

CLI: gsalign-tpu-torch import <bwa_prefix> <out_prefix>
"""

from __future__ import annotations

import os
import struct
from typing import List, Optional, Tuple

import numpy as np

from gsalign_tpu_torch.genome.packing import Genome, Hole


def read_ann(path: str) -> Tuple[int, int, int, List[Tuple[str, int, int]]]:
    """Parse a .ann: (l_pac, n_seqs, seed, [(name, offset, length), ...])."""
    with open(path, "r") as fh:
        first = fh.readline().split()
        l_pac, n_seqs, seed = int(first[0]), int(first[1]), int(first[2])
        seqs = []
        for _ in range(n_seqs):
            head = fh.readline().split(None, 2)       # gi name [comment]
            name = head[1]
            rest = fh.readline().split()
            offset, length = int(rest[0]), int(rest[1])
            seqs.append((name, offset, length))
    return l_pac, n_seqs, seed, seqs


def read_amb(path: str) -> Tuple[int, List[Hole]]:
    """Parse a .amb: (l_pac, holes)."""
    holes: List[Hole] = []
    with open(path, "r") as fh:
        first = fh.readline().split()
        l_pac, n_holes = int(first[0]), int(first[2])
        for _ in range(n_holes):
            toks = fh.readline().split()
            holes.append(Hole(int(toks[0]), int(toks[1]), ord(toks[2][0])))
    return l_pac, holes


def read_pac(path: str, l_pac: int) -> np.ndarray:
    """Decode the forward-only 2-bit .pac into uint8 codes [l_pac].

    Layout (bntseq.c:192-205): ceil(l_pac/4) packed bytes (+1 zero byte
    when l_pac%4 == 0), then one trailing byte holding l_pac % 4. Base i
    lives at bits (~i & 3) * 2 of byte i >> 2 (bwt_index.cpp:201)."""
    raw = np.fromfile(path, dtype=np.uint8)
    n_bytes = (l_pac >> 2) + (0 if l_pac % 4 == 0 else 1)
    if raw.shape[0] < n_bytes + 1:
        raise ValueError(f".pac too short for l_pac={l_pac}")
    if int(raw[-1]) != l_pac % 4:
        raise ValueError(".pac trailing length byte mismatch "
                         f"({int(raw[-1])} != {l_pac % 4})")
    packed = raw[:n_bytes]
    # expand: byte -> 4 bases, high bits first
    shifts = np.array([6, 4, 2, 0], dtype=np.uint8)
    codes = ((packed[:, None] >> shifts[None, :]) & 3).reshape(-1)
    return codes[:l_pac].astype(np.uint8)


def read_bwt_header(path: str) -> Optional[Tuple[int, np.ndarray]]:
    """(primary, L2[1..4]) from a .bwt, or None if absent.

    Header layout (bwt_restore_bwt, src/bwt_index.cpp:102-121): five
    little-endian int64 (bwtint_t): primary then L2[1..4]."""
    if not os.path.exists(path):
        return None
    with open(path, "rb") as fh:
        hdr = fh.read(40)
    if len(hdr) < 40:
        return None
    vals = struct.unpack("<5q", hdr)
    return vals[0], np.asarray(vals[1:], dtype=np.int64)


def load_bwa_genome(prefix: str) -> Genome:
    """Reconstruct the Genome model from .pac/.ann/.amb at `prefix`."""
    l_pac, n_seqs, seed, seqs = read_ann(prefix + ".ann")
    l_pac2, holes = read_amb(prefix + ".amb")
    if l_pac2 != l_pac:
        raise ValueError(f"inconsistent .ann/.amb l_pac ({l_pac} vs {l_pac2})")
    codes = read_pac(prefix + ".pac", l_pac)
    return Genome(
        names=[s[0] for s in seqs],
        lengths=np.asarray([s[2] for s in seqs], dtype=np.int64),
        offsets=np.asarray([s[1] for s in seqs], dtype=np.int64),
        holes=holes,
        codes_fwd=codes,
        seed=seed,
    )


def import_bwa_index(prefix: str, threads: Optional[int] = None,
                     check_bwt: bool = True):
    """Load a five-file reference index and rebuild our FMIndex from it.

    Returns the FMIndex; raises ValueError when the .bwt header disagrees
    with the rebuilt index (corrupt or mismatched file set)."""
    from gsalign_tpu_torch.index.fmindex import build_fmindex
    genome = load_bwa_genome(prefix)
    fm = build_fmindex(genome, threads=threads)
    if check_bwt:
        hdr = read_bwt_header(prefix + ".bwt")
        if hdr is not None:
            primary, l2 = hdr
            if primary != fm.primary:
                raise ValueError(
                    f".bwt primary {primary} != rebuilt {fm.primary} — "
                    "index files do not match the .pac")
            if not np.array_equal(l2, np.asarray(fm.l2[1:5])):
                raise ValueError(".bwt L2 counts disagree with the .pac")
    return fm
