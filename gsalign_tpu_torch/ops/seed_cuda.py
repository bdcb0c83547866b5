"""Hand-written Hopper kernels of the seed stage (csrc/seed.cu) and their
wrappers.

    seed_scan   every scan lane run to its end in one launch, a warp per
                lane; replaces the JAX package's whole seed-scan while_loop
                (ops/seeding.py _seed_scan_impl) in the xla and none SA
                modes. Plain version: seeding.seed_scan_plain.
    seed_lockstep  the same loop in lock step, every lane one step an
                iteration, run on the card in one cooperative launch with
                one grid barrier an iteration; pallas SA mode needs it (its
                compaction slots couple the lanes), and makes the slots and
                reads their SA words (the masked gather) inside it. Plain
                version: the host loop seeding.scan_lockstep(plain=True).
    seed_step   seed_lockstep for one iteration; replaces that loop's body
                and is the lane-by-lane diffing tool. Plain version: one
                iteration of the host loop (seeding.seed_step_plain after
                seeding._sa_slots).
    resolve_sa  LF-walk ranks to their sampled SA rows, a group of threads
                a rank (16 narrow, 32 wide); replaces the JAX package's rank.resolve_sa
                while_loop. Plain version: rank.resolve_sa.
    occ_rows    strict ranks of given (rank, class, mode) by the kernels'
                row decode alone; on no path, the tests' window on the
                decode. Plain version: rank.occ_t3.

Each kernel runs narrow and wide indexes (ops/rank.py), by an instance of
its row layout, and each but occ_rows a row-sharded index
(parallel/mesh.shard_index_rows) by an instance that reads t3 and
sa_samples through their blocks' addresses (csrc/seed.cu ShardedTable;
seed_lockstep's for narrow rows only).

On a CPU tensor a wrapper runs the plain version. On a CUDA tensor it
launches its kernel or raises: a build or launch failure is an error, never
a silent fallback. Each wrapper counts its launches in `.launches`, those
of its sharded instance in `.sharded_launches`. The kernels read the
DeviceFMIndex tensors as they are (see ops/rank.py). seed_scan and
seed_lockstep come in two halves too, the launch and the read-back
(scan_launch / scan_result, lockstep_launch / lockstep_result), so that a
mesh launches every stripe before it reads any back.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from gsalign_tpu_torch.ops import cuda_build
from gsalign_tpu_torch.ops import rank as rank_ops
from gsalign_tpu_torch.ops import seeding

_vp, _ll = ctypes.c_void_p, ctypes.c_longlong
# csrc/seed.cu kMaxShards: the most row blocks of a table (a mesh's
# entries), more than the cards of any one host
MAX_SHARDS = 1024


class _Shards(ctypes.Structure):
    """csrc/seed.cu Shards: a table's row blocks (rows 0: read whole)."""
    _fields_ = [("block", _vp * MAX_SHARDS), ("rows", _ll)]


class _SeedArgs(ctypes.Structure):
    """csrc/seed.cu SeedArgs, field for field."""
    _fields_ = [(n, _vp) for n in (
        "q_rows", "t3", "t3_major", "t3_exc_pos", "t3_exc_chr",
        "comb_pairs", "init_corr", "text_rows", "sa_rows", "starts",
        "emit_stops", "ext_stops", "hard_stops", "state", "out",
        "block_counts", "counters")] + [(n, _ll) for n in (
            "B", "max_out", "min_seed_length", "max_seed_freq", "sensitive",
            "order", "use_init", "use8", "seq_len", "n_look", "mode",
            "win_words", "step_cap", "gather_k", "max_iters", "blocks",
            "lanes_per_warp", "wide", "comb_init_off", "comb_half")] + [
                ("t3_shards", _Shards)]


class _ResolveArgs(ctypes.Structure):
    """csrc/seed.cu ResolveArgs, field for field."""
    _fields_ = [(n, _vp) for n in (
        "t3", "t3_major", "t3_exc_pos", "t3_exc_chr", "l2", "sa", "sa64",
        "k", "out")] + [(n, _ll) for n in (
            "n", "primary", "seq_len", "sa_intv", "wide")] + [
                ("t3_shards", _Shards), ("sa_shards", _Shards)]


class _OccArgs(ctypes.Structure):
    """csrc/seed.cu OccArgs, field for field."""
    _fields_ = [(n, _vp) for n in (
        "t3", "t3_major", "t3_exc_pos", "t3_exc_chr", "k", "cls", "triple",
        "out")] + [(n, _ll) for n in ("n", "wide")]


# the C entry points of csrc/seed.cu; each returns a CUDA error code
SIGNATURES = {
    "gsalign_seed_scan": [ctypes.POINTER(_SeedArgs), _vp],
    "gsalign_seed_lockstep": [ctypes.POINTER(_SeedArgs), _vp],
    "gsalign_seed_lockstep_blocks": [_ll, _ll, _ll,
                                     ctypes.POINTER(ctypes.c_int)],
    "gsalign_resolve_sa": [ctypes.POINTER(_ResolveArgs), _vp],
    "gsalign_occ_rows": [ctypes.POINTER(_OccArgs), _vp],
    "gsalign_seed_scan_occupancy": [_ll, _ll, ctypes.POINTER(ctypes.c_int),
                                    ctypes.POINTER(ctypes.c_int)],
    "gsalign_enable_peer": [ctypes.c_int]}


def build() -> ctypes.CDLL:
    """Build (see ops/cuda_build.py) and load csrc/seed.cu."""
    return cuda_build.bind("seed", SIGNATURES)


def _ptr(t: Optional[torch.Tensor], dtype, dev, name: str):
    """Device pointer of a contiguous tensor of `dtype` on `dev`."""
    if t is None:
        return None
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, not {dev}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return t.data_ptr()


def sharded(dfm) -> bool:
    """Whether the kernels read this index's t3 and sa_samples by blocks."""
    return dfm.row_shards is not None


_peers: set = set()      # (device, peer) pairs with peer access enabled


def _shards(dfm, field: str, dtype, dev) -> _Shards:
    """The row blocks of one of a sharded index's tables (a table that
    is not cut: one block of all its rows), after checking each block. A
    block on another card needs peer access from `dev`, enabled here once;
    where it is not possible, raise."""
    sh = dfm.row_shards.get(field)
    blocks = sh.blocks if sh is not None else (getattr(dfm, field),)
    if len(blocks) > MAX_SHARDS:
        raise ValueError(f"{field} is cut into {len(blocks)} blocks; the "
                         f"kernels take at most MAX_SHARDS = {MAX_SHARDS} "
                         f"(csrc/seed.cu kMaxShards)")
    out = _Shards(rows=sh.rows if sh is not None else blocks[0].shape[0])
    for i, blk in enumerate(blocks):
        if blk.device != dev:
            if blk.device.type != "cuda" or dev.type != "cuda" or \
                    not torch.cuda.can_device_access_peer(dev, blk.device):
                raise ValueError(f"{field} block {i} is on {blk.device}, "
                                 f"which {dev} cannot read")
            if (dev, blk.device) not in _peers:
                with torch.cuda.device(dev):
                    cuda_build.raise_on(
                        build().gsalign_enable_peer(blk.device.index),
                        "peer access")
                _peers.add((dev, blk.device))
        out.block[i] = _ptr(blk, dtype, blk.device, f"{field} block {i}")
    return out


def _seed_args(dfm, q_rows, lanes, prm, win_words=0, step_cap=0,
               block_counts=None, **lockstep) -> _SeedArgs:
    """The argument struct of seed_scan and seed_lockstep (whose plan is
    `lockstep`: gather_k, max_iters, blocks, lanes_per_warp), after
    checking every tensor."""
    dev = lanes.st.device
    mode = seeding.SA_MODES.index(prm.sa_mode)
    if prm.sa_mode != "none" and not dfm.direct_ok:
        raise ValueError("direct mode needs a full-SA index")
    B = lanes.st.shape[1]
    if lanes.st.shape != (seeding.N_FIELDS, B) or \
            lanes.out.shape != (B, prm.max_out, 3) or \
            lanes.starts.shape != (B,) or lanes.bounds.shape != (3, B) or \
            lanes.counters.shape != (seeding.N_COUNTERS,) or \
            (block_counts is not None and block_counts.shape
             != (2 * lockstep["blocks"] + 1,)):
        raise ValueError("lane tensors disagree in shape")
    if q_rows.dim() != 2 or q_rows.shape[0] < 1 or q_rows.shape[1] != 64:
        raise ValueError(f"q_rows must be [R >= 1, 64], got "
                         f"{tuple(q_rows.shape)}")
    i64, i32 = torch.int64, torch.int32
    direct = prm.sa_mode != "none"
    return _SeedArgs(
        q_rows=_ptr(q_rows, i32, dev, "q_rows"),
        t3=None if sharded(dfm) else _ptr(dfm.t3, i32, dev, "t3"),
        t3_shards=_shards(dfm, "t3", i32, dev) if sharded(dfm)
        else _Shards(),
        t3_major=_ptr(dfm.t3_major, i32, dev, "t3_major"),
        t3_exc_pos=_ptr(dfm.t3_exc_pos, i64, dev, "t3_exc_pos"),
        t3_exc_chr=_ptr(dfm.t3_exc_chr, i64, dev, "t3_exc_chr"),
        comb_pairs=_ptr(dfm.comb_pairs, i64, dev, "comb_pairs"),
        init_corr=_ptr(dfm.init_corr, i64, dev, "init_corr"),
        text_rows=_ptr(dfm.text_rows, i32, dev, "text_rows")
        if direct else None,
        sa_rows=_ptr(dfm.sa_rows, i32, dev, "sa_rows") if direct else None,
        starts=_ptr(lanes.starts, i64, dev, "starts"),
        emit_stops=_ptr(lanes.emit_stops, i64, dev, "emit_stops"),
        ext_stops=_ptr(lanes.ext_stops, i64, dev, "ext_stops"),
        hard_stops=_ptr(lanes.hard_stops, i64, dev, "hard_stops"),
        state=_ptr(lanes.st, i64, dev, "state"),
        out=_ptr(lanes.out, i64, dev, "out"),
        block_counts=_ptr(block_counts, i64, dev, "block_counts"),
        counters=_ptr(lanes.counters, i64, dev, "counters"),
        B=B, max_out=prm.max_out, min_seed_length=prm.min_seed_length,
        max_seed_freq=prm.max_seed_freq, sensitive=int(prm.sensitive),
        order=dfm.init_order,
        use_init=int(prm.min_seed_length > dfm.init_order and prm.init12),
        use8=int(prm.min_seed_length > 8), seq_len=dfm.seq_len,
        n_look=q_rows.shape[0] * 256, mode=mode,
        win_words=win_words, step_cap=step_cap, wide=int(dfm.wide),
        comb_init_off=rank_ops.INIT_OFF_WIDE if dfm.wide
        else rank_ops.INIT_OFF,
        comb_half=rank_ops.COMB_HALF if dfm.wide else 0, **lockstep)


# the scans stage each lane's query window in shared memory, a lane a warp,
# four warps a seed_scan block and sixteen a seed_lockstep block (csrc/seed.cu
# kScanWarps, kLockWarps): a block may use 227 KB (232,448 bytes) on an H100
_SCAN_WARPS = 4
_LOCK_WARPS = 16
_MAX_SHARED_BYTES = 232448


def _scan_head_bytes(wide: bool) -> int:
    """The scans' shared tables before the query windows (csrc/seed.cu
    Heads::kScanHead): comb_pairs' 136 class rows (a wide index stages
    their lo and their sz plane), init_corr, t3_exc_pos and t3_exc_chr, 8
    bytes each."""
    return ((2 if wide else 1) * 136 + 12 + 3 + 3) * 8


def _win_words(max_len: int) -> int:
    """32-bit words a plane of a staged query window of a lane whose
    extensions stop max_len bases past its start (its ext bound): a lane
    reads from its start's word to 16 words of compare and one of shift
    past its ext bound's word."""
    return (max_len >> 4) + 20


def _step_cap(emit_len: int, ext_len: Optional[int] = None) -> int:
    """The most steps a lane can take that scans starts over emit_len bases
    from its start and extends to ext_len bases from it (ext_len >=
    emit_len; None: ext_len = emit_len, one bound), seed_scan's limit.
    From a cursor c an extension is one INIT step, then EXT steps that each
    move ext_pos forward (to at most the ext bound), each preceded by at
    most one triple miss that moves nothing, then one finalizing step, again
    after at most one triple miss: at most 2 * (ext - c) + 3 steps, after
    which the cursor stands at c + 1 or further, or at the emit bound where
    the extension poisons the lane. An INIT step that starts no extension
    moves the cursor by one. Summed over every c in [start, emit), E =
    emit_len and X = ext_len: 2 X E - E (E - 1) + 3 E = E (2 X - E + 4),
    which is X (X + 4) for one bound. It grows with X, and with E for E <=
    X, so the longest emit and ext spans of a launch bound all its lanes."""
    if ext_len is None:
        ext_len = emit_len
    return emit_len * (2 * ext_len - emit_len + 4)


def seed_scan(dfm, q_rows: torch.Tensor, lanes, prm) -> np.ndarray:
    """Kernel seed_scan: every lane of `lanes` (seeding.ScanLanes) run to
    its end, in place, in one launch. Returns the final lane state on the
    host (int64 [N_FIELDS, B]): reading it back is the scan's one
    synchronisation. Raises if a lane exceeded the step limit."""
    return scan_result(lanes, scan_launch(dfm, q_rows, lanes, prm))


def scan_launch(dfm, q_rows: torch.Tensor, lanes, prm) -> int:
    """seed_scan's first half: the launch on the lanes' device and current
    stream, nothing read back (on the CPU: the whole plain scan). Returns
    the step limit, which scan_result checks."""
    dev = lanes.st.device
    if dev.type == "cpu":
        seeding.seed_scan_plain(dfm, q_rows, lanes, prm)
        return 0
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if prm.sa_mode == "pallas":
        raise ValueError("seed_scan runs the xla and none SA modes: pallas "
                         "mode couples the lanes and needs the lock step")
    win_words = _win_words(lanes.max_len)
    shared = _scan_head_bytes(dfm.wide) + _SCAN_WARPS * 2 * win_words * 4
    if shared > _MAX_SHARED_BYTES:
        raise ValueError(f"lanes that extend {lanes.max_len} bases need "
                         f"{shared} bytes of shared memory a block; the card "
                         f"has {_MAX_SHARED_BYTES}")
    args = _seed_args(dfm, q_rows, lanes, prm, win_words=win_words,
                      step_cap=_step_cap(lanes.max_emit, lanes.max_len))
    if lanes.st.shape[1]:
        cuda_build.raise_on(build().gsalign_seed_scan(
            ctypes.byref(args), cuda_build.stream(dev)), "seed_scan")
        cuda_build.count(seed_scan, "sharded_launches" if sharded(dfm)
                         else "launches")
    return args.step_cap


def scan_result(lanes, step_cap: int) -> np.ndarray:
    """seed_scan's second half: the final lane state read back (on a card
    the scan's one synchronisation, on the current stream); raises if a
    lane exceeded the step limit."""
    st = lanes.read_back()[0]
    over = np.flatnonzero(st[seeding.F_STEPS] < 0)
    if over.size:
        raise RuntimeError(f"seed_scan: lanes {over[:8].tolist()} exceeded "
                           f"the step limit {step_cap}")
    return st


seed_scan.launches = 0
seed_scan.sharded_launches = 0


def lockstep_plan(B: int, staged_blocks: int, bare_blocks: int,
                  max_blocks: Optional[int] = None):
    """seed_lockstep's grid for B lanes: (blocks, lanes a warp, staged).
    staged_blocks and bare_blocks are the blocks the card holds at once
    with and without the lanes' query windows in shared memory
    (resident_blocks); max_blocks caps the grid below that. A warp a lane
    with the window staged where that fits; else each warp owns a run of
    consecutive lanes, as few as the grid allows."""
    if max_blocks is not None:
        staged_blocks = min(staged_blocks, max_blocks)
        bare_blocks = min(bare_blocks, max_blocks)
    want = -(-B // _LOCK_WARPS)
    if want <= staged_blocks:
        return want, 1, True
    if bare_blocks < 1:
        raise ValueError(f"seed_lockstep needs a grid of at least one "
                         f"block, got {bare_blocks}")
    per = -(-B // (_LOCK_WARPS * min(bare_blocks, want)))
    return -(-B // (_LOCK_WARPS * per)), per, False


def slots_blockwise(need: np.ndarray, lanes_per_block: int, K: int
                    ) -> np.ndarray:
    """The compaction slots as the seed_lockstep kernel makes them, on the
    host: each block of consecutive lanes counts its needy lanes, a lane's
    position is the exclusive sum of the counts of the blocks before its
    own plus its rank among its block's needy lanes, and positions of K and
    above get no slot (-1). Equals seeding._sa_slots' slot (the tests hold
    one against the other); nothing on a card's path calls it."""
    need = np.asarray(need, dtype=bool)
    B = need.shape[0]
    pad = -B % lanes_per_block
    blocks = np.concatenate([need, np.zeros(pad, bool)]).reshape(
        -1, lanes_per_block)
    counts = blocks.sum(1)
    before = np.cumsum(counts) - counts
    pos = (before[:, None] + np.cumsum(blocks, 1) - 1).reshape(-1)[:B]
    return np.where(need & (pos < K), pos, -1)


def resident_blocks(lib, win_words: int, wide: bool = False,
                    row_sharded: bool = False) -> int:
    """The most seed_lockstep blocks of a row layout and table source that
    the current device holds at once, with query windows of win_words words
    staged (none for win_words < 0)."""
    n = ctypes.c_int(0)
    cuda_build.raise_on(lib.gsalign_seed_lockstep_blocks(
        win_words, int(wide), int(row_sharded), ctypes.byref(n)),
        "seed_lockstep occupancy query")
    return n.value


def launch_lockstep(lib, stream, dfm, q_rows, lanes, prm, max_iters: int,
                    max_blocks: Optional[int]) -> None:
    """Plan and launch seed_lockstep from the loaded library `lib` on the
    lanes' device. (Apart from the wrapper below, the host rehearsal of
    csrc/seed.cu calls it, with a library built for the host.)"""
    B = lanes.st.shape[1]
    win_words = _win_words(lanes.max_len)
    if sharded(dfm) and dfm.wide:
        raise ValueError("seed_lockstep has no row-sharded instance for wide "
                         "rows (the lock step is pallas mode's, on a narrow "
                         "direct index)")
    kw = {"row_sharded": True} if sharded(dfm) else {}
    blocks, per, staged = lockstep_plan(
        B, resident_blocks(lib, win_words, dfm.wide, **kw),
        resident_blocks(lib, -1, dfm.wide, **kw), max_blocks)
    K = min(seeding._SA_GATHER_K, B)
    # every iteration steps at least one lane, or the first K needy ones
    cap = _step_cap(lanes.max_emit, lanes.max_len) * (
        B if prm.sa_mode == "pallas" and B > K else 1)
    # the blocks' counts, by the iteration's parity, and the grid barrier's
    # word, which starts at zero
    counts = torch.zeros(2 * blocks + 1, dtype=torch.int64,
                         device=lanes.st.device)
    args = _seed_args(dfm, q_rows, lanes, prm,
                      win_words=win_words if staged else 0, step_cap=cap,
                      block_counts=counts, gather_k=K, max_iters=max_iters,
                      blocks=blocks, lanes_per_warp=per)
    cuda_build.raise_on(lib.gsalign_seed_lockstep(ctypes.byref(args), stream),
                        "seed_lockstep")


def seed_lockstep(dfm, q_rows: torch.Tensor, lanes, prm, max_iters: int = 0,
                  max_blocks: Optional[int] = None):
    """Kernel seed_lockstep: every lane of `lanes` (seeding.ScanLanes) in
    lock step, in place, in one cooperative launch: until no lane is live,
    or for max_iters iterations (max_iters > 0). max_blocks caps the grid
    (a test forces several lanes a warp with it); a grid the card cannot
    hold at once raises. Returns (lane state int64 [N_FIELDS, B], counters
    int64 [N_COUNTERS]: seeding.C_ITERS, C_LIVE, C_GATHERED, C_STALLED) on
    the host: reading them back is the scan's one synchronisation. Raises
    if the scan ran into the iteration limit. Beside its launches it counts
    the SA words its launches gathered and the lane-iterations they stalled
    (.gathered, .stalled)."""
    lockstep_launch(dfm, q_rows, lanes, prm, max_iters, max_blocks)
    return lockstep_result(lanes, max_iters)


def lockstep_launch(dfm, q_rows: torch.Tensor, lanes, prm, max_iters: int = 0,
                    max_blocks: Optional[int] = None) -> None:
    """seed_lockstep's first half: the launch on the lanes' device and
    current stream, nothing read back (on the CPU: the whole host loop)."""
    dev = lanes.st.device
    if dev.type == "cpu":
        seeding.scan_lockstep(dfm, q_rows, lanes, prm, plain=True,
                              max_iters=max_iters)
        return
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    lanes.counters.zero_()
    if lanes.max_emit > 0:
        launch_lockstep(build(), cuda_build.stream(dev), dfm, q_rows, lanes,
                        prm, max_iters, max_blocks)
        cuda_build.count(seed_lockstep, "sharded_launches" if sharded(dfm)
                         else "launches")


def lockstep_result(lanes, max_iters: int = 0):
    """seed_lockstep's second half: (lane state, counters) read back, the
    words gathered and the stalls counted; raises if the scan ran into the
    iteration limit (max_iters 0)."""
    if lanes.st.device.type == "cpu":
        return lanes.read_back()
    st, counters = lanes.read_back()
    cuda_build.count(seed_lockstep, "gathered",
                     int(counters[seeding.C_GATHERED]))
    cuda_build.count(seed_lockstep, "stalled",
                     int(counters[seeding.C_STALLED]))
    if max_iters <= 0 and counters[seeding.C_LIVE] > 0:
        raise RuntimeError(f"seed_lockstep: {counters[seeding.C_LIVE]} lanes "
                           f"still live at the iteration limit "
                           f"{counters[seeding.C_ITERS]}")
    return st, counters


seed_lockstep.launches = 0
seed_lockstep.sharded_launches = 0
seed_lockstep.gathered = 0
seed_lockstep.stalled = 0


def seed_step(dfm, q_rows: torch.Tensor, lanes, prm) -> int:
    """Kernel seed_step: one lock-step iteration of every lane of `lanes`
    (seeding.ScanLanes), in place: seed_lockstep with max_iters = 1, the
    slots and their reads made inside it. Returns the count of lanes still
    live. Its launches are counted here and in seed_lockstep.launches."""
    n0 = seed_lockstep.launches
    counters = seed_lockstep(dfm, q_rows, lanes, prm, max_iters=1)[1]
    seed_step.launches += seed_lockstep.launches - n0
    return int(counters[seeding.C_LIVE])


seed_step.launches = 0


def _resolve_args(dfm, k: torch.Tensor, out: torch.Tensor) -> _ResolveArgs:
    """The kernel's argument struct, after checking every tensor."""
    dev, i64, i32 = k.device, torch.int64, torch.int32
    sa = rank_ops.sa_table(dfm)
    sa_dtype = i64 if dfm.wide else i32
    if sharded(dfm):
        if dfm.direct_ok:
            raise ValueError("a direct index resolves its ranks on the host")
        return _ResolveArgs(
            t3_major=_ptr(dfm.t3_major, i32, dev, "t3_major"),
            t3_exc_pos=_ptr(dfm.t3_exc_pos, i64, dev, "t3_exc_pos"),
            t3_exc_chr=_ptr(dfm.t3_exc_chr, i64, dev, "t3_exc_chr"),
            l2=_ptr(dfm.l2, i64, dev, "l2"),
            k=_ptr(k, i64, dev, "k"), out=_ptr(out, i64, dev, "out"),
            n=k.shape[0], primary=dfm.primary, seq_len=dfm.seq_len,
            sa_intv=dfm.sa_intv, wide=int(dfm.wide),
            t3_shards=_shards(dfm, "t3", i32, dev),
            sa_shards=_shards(dfm, "sa_samples", sa_dtype, dev))
    return _ResolveArgs(
        t3=_ptr(dfm.t3, i32, dev, "t3"),
        t3_major=_ptr(dfm.t3_major, i32, dev, "t3_major"),
        t3_exc_pos=_ptr(dfm.t3_exc_pos, i64, dev, "t3_exc_pos"),
        t3_exc_chr=_ptr(dfm.t3_exc_chr, i64, dev, "t3_exc_chr"),
        l2=_ptr(dfm.l2, i64, dev, "l2"),
        sa=None if dfm.wide else _ptr(sa, i32, dev, "sa"),
        sa64=_ptr(sa, i64, dev, "sa") if dfm.wide else None,
        k=_ptr(k, i64, dev, "k"), out=_ptr(out, i64, dev, "out"),
        n=k.shape[0], primary=dfm.primary, seq_len=dfm.seq_len,
        sa_intv=dfm.sa_intv, wide=int(dfm.wide))


def resolve_sa(dfm, k: torch.Tensor) -> torch.Tensor:
    """Kernel resolve_sa: SA values of ranks k (int64 [n]) -> int64 [n]."""
    if k.dtype != torch.int64 or k.dim() != 1:
        raise TypeError(f"ranks must be int64 [n], got {k.dtype} "
                        f"{tuple(k.shape)}")
    dev = k.device
    if dev.type == "cpu":
        return rank_ops.resolve_sa(dfm, k)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    k = k.contiguous()
    out = torch.empty_like(k)
    if k.shape[0]:
        args = _resolve_args(dfm, k, out)
        cuda_build.raise_on(build().gsalign_resolve_sa(
            ctypes.byref(args), cuda_build.stream(dev)), "resolve_sa")
        cuda_build.count(resolve_sa, "sharded_launches" if sharded(dfm)
                         else "launches")
    return out


resolve_sa.launches = 0
resolve_sa.sharded_launches = 0


def occ_args(dfm, k: torch.Tensor, cls: torch.Tensor, triple: torch.Tensor,
             out: torch.Tensor) -> _OccArgs:
    """occ_rows' argument struct, after checking every tensor."""
    dev, i64, i32 = k.device, torch.int64, torch.int32
    n = k.shape[0]
    if cls.shape != (n,) or triple.shape != (n,) or out.shape != (n,):
        raise ValueError("ranks, classes, modes and out disagree in shape")
    return _OccArgs(
        t3=_ptr(dfm.t3, i32, dev, "t3"),
        t3_major=_ptr(dfm.t3_major, i32, dev, "t3_major"),
        t3_exc_pos=_ptr(dfm.t3_exc_pos, i64, dev, "t3_exc_pos"),
        t3_exc_chr=_ptr(dfm.t3_exc_chr, i64, dev, "t3_exc_chr"),
        k=_ptr(k, i64, dev, "k"), cls=_ptr(cls, i64, dev, "cls"),
        triple=_ptr(triple, i64, dev, "triple"),
        out=_ptr(out, i64, dev, "out"), n=n, wide=int(dfm.wide))


def occ_rows(dfm, k: torch.Tensor, cls: torch.Tensor, triple: torch.Tensor
             ) -> torch.Tensor:
    """Kernel occ_rows: the strict rank of class cls[i] at rank k[i], in
    triple mode where triple[i] (int64 [n] each) -> int64 [n], as many
    threads a query as resolve_sa takes a rank."""
    dev = k.device
    if dev.type == "cpu":
        return rank_ops.occ_t3(dfm, k, triple != 0, cls)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    k, cls, triple = (x.to(torch.int64).contiguous() for x in (k, cls, triple))
    out = torch.empty_like(k)
    if k.shape[0]:
        cuda_build.raise_on(build().gsalign_occ_rows(
            ctypes.byref(occ_args(dfm, k, cls, triple, out)),
            cuda_build.stream(dev)), "occ_rows")
        cuda_build.count(occ_rows)
    return out


occ_rows.launches = 0
