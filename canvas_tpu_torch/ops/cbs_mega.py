"""The whole-recursion CBS engine: the full DNAcopy segmentation (arc scan,
OU tail probability, sequential-stopping permutation walks and
split-location edge tests) with the recursion's state in device tensors,
the final leaf segment table read back once.

Reference semantics: ``CanvasPartition/{ChangePoint,CBSTStatistic,
GetBoundary,TailProbability}.cs``, the same algorithm as the host parity
oracle (``ops/cbs.py``) and the frontier engine (``ops/cbs_device.py``).
It is the counterpart of the JAX package's default CBS engine on an
accelerator and draws the same permutations: on the same input it returns
the same segments.

Design:
  * A fixed-capacity segment table ``[S]`` of (contig, lo, hi, pending)
    slots carries the recursion frontier from level to level.  A split
    turns the parent slot into its first piece and appends the others at a
    cursor; an append beyond the table goes to a slot that is thrown away
    and sets the overflow flag, and the caller then runs the frontier
    engine.
  * Each level analyses the first W pending slots (a stable compaction):
    window gather and centring, the arc scan through kernel B4 at the
    smallest power-of-two tier width (1,024 to Tmax) that holds each
    segment, each tier's rows under its row mask, and the OU tail
    probability.
  * The sequential-stopping boundary walk (ChangePoint.cs:206-246) runs
    vectorised over a permutation chunk: with ``csum`` the running count of
    permuted statistics at or above the observed one, the first index where
    ``nrej > nrejc`` (reject) or ``np_i >= sbdry[k-1]`` (accept) decides;
    reject wins an exact tie because the reference checks it first.  Each
    row draws its chunks at its own tier width.
  * Split-location edge tests (ChangePoint.cs:359-398, TPermP) draw their
    m1-subsets as the m1 smallest of iid 32-bit keys (the m1-th order
    statistic, ties by index), and stop as soon as the rejection count
    cannot come back under alpha * n_perm.
  * Keys are threefry ``fold_in`` chains on (contig, lo, n), then the
    chunk counter (walks) or 7777 / 7778 and the chunk counter (edges), as
    in the JAX package (ops/threefry.py, equal bit for bit).  Kernels K7
    and K8 derive them on the card from the level key and the rows'
    (contig, lo, n); on CPU tensors their plain versions run the chains
    (cbs_mega_cuda.seg_keys, edge_keys).
  * The walks and the edge tests of a level are one launch each, kernels
    K7 and K8 (ops/cbs_mega_cuda.py), which loop over every row's chunks
    on the card until the row is decided; on CPU tensors their plain
    versions loop over the rows one at a time.  A row's chunk c draws
    from its own key and counter, so the results do not depend on which
    rows share an iteration.
  * The level body's glue is kernels K13-K16 (ops/cbs_level_cuda.py): the
    compaction, gathers, centring, cumsum and tier masks; the decision
    rules, carried by K11's launch as the JAX package computes them in the
    tail probability's program; the edge tests' set-up; the table update,
    in one launch with the edge tests' keep flags.  The table lives in
    one device buffer with its control words (nseg, overflow, live, the
    level count, the tally), updated in place; every kernel of a level
    returns at once where live is 0, so a level after the run's end
    changes nothing, and a tier without a row costs its kernels an early
    return (K9, B4 and K10 take the tier's row mask; K10 writes its rows'
    t2, ti, tj in place).
  * On the card one level is captured in a CUDA graph, once per shape
    (each device keeps the engine of its last run's shape), and replayed in batches of 4, 8, 16, ... levels up to _MAX_LEVELS,
    with one read from the device after each batch: the table and its
    control words, so the read that finds live 0 carries the final table.
    A recursion of up to 4 levels (the enrichment panel's and bench.py's
    CBS workload's) is one replay batch and one read.  Nothing else in the
    engine reads from the device, and nothing copies to it after the
    set-up.  On CPU tensors the same level runs eagerly through the plain
    versions, with a read after every level.  A failed capture or launch
    raises; nothing runs the level another way instead.
  * Sums and cumulative sums accumulate in float64 and round once to f32,
    and the tail probability runs in float64, so a CUDA run and a CPU run
    see the same statistics wherever the order of a float64 sum changes
    no bit of its f32 result (csrc/cbs_level.cu's note on exactness; held
    on every level of the panel and of bench.py's CBS workload).

Documented deviations from the host path, as for the frontier engine
(Monte-Carlo-level): threefry permutations instead of the numpy stream,
f32 statistics with the reference's 1e-5 slack factor, exact arc-scan
ties resolved at block granularity.

Deviation from the JAX package's engine (C5, settled: float64 kept): the
tail probability p1 is float64 here, rounded to f32 before tail_ok = p1
<= alpha and the walk's limit nrejc = int((alpha - p1) n_perm); the JAX
package takes it in float32, off from its own float64 tail by up to
1.6e-4 relative on tests/test_torch_cbs_stats.py's level batch.  tail_ok
agrees, but a limit differs on the rare rows whose (alpha - p1) n_perm
lies that close to an integer, a limit one apart, which can decide a walk
the other way.  The float64 limit is the one the host
engine's float64 tail and Canvas's C# double give, and it keeps a CUDA
run equal to a CPU run (no float32 kernel could match XLA's float32 erfc
and exp bit for bit).  tests/test_torch_cbs_mega.py::
test_tail_precision_changes_walk_limits_c5 shows it.
"""

from __future__ import annotations

import threading
import time
from contextlib import nullcontext

import numpy as np
import torch

from canvas_tpu_torch.config import resolve_device
from canvas_tpu_torch.ops import arc_scan_cuda, cbs_level_cuda, cbs_mega_cuda
from canvas_tpu_torch.ops import cbs as _cbs
from canvas_tpu_torch.ops import cbs_stats_cuda
from canvas_tpu_torch.ops.cbs_device import tmax_batch
from canvas_tpu_torch.ops.cbs_level_cuda import (CTL, LEVEL, LIVE, NSEG,
                                                 OVERFLOW, TALLY,
                                                 TALLY_WORDS)
from canvas_tpu_torch.pipeline.profiling import span

_MAX_LEVELS = 128      # iteration bound (depth x frontier/W chunks)
_MAX_BINS = 65536      # the longest contig the table's tiers hold
_MAX_CONTIGS = 192
_MIN_SLOTS = 64        # the table holds max(64, 4 x contigs) slots
_FIRST_BATCH = 4       # levels replayed before the first read

# reads of control values and results from the device, one per copy
SYNCS = {"cbs_mega": 0}
# levels captured in a CUDA graph, and replays of them (each engine keeps
# its capture's seconds, nodes and kernel launches a level)
GRAPHS = {"captures": 0, "replays": 0}
# the recursion's work, from the device's tally: runs of the engine, and
# their walk chunks and arc pairs (cbs_level_cuda's TALLY_WORDS)
WORK = {"calls": 0, "walk_chunks": 0, "arc_pairs": 0}


def _read(tab: torch.Tensor) -> list[int]:
    """The table and its control words, copied to the host in one read
    (the span "engine.read": the wait for the batch, then the copy)."""
    SYNCS["cbs_mega"] += 1
    with span("engine.read"):
        return tab.tolist()


def _tiers(Tmax: int) -> list[int]:
    """Ascending width ladder (powers of two down to 1024): the [P, w]
    permutation sort and the arc scan both scale with the width, so every
    segment runs at the smallest tier that holds it."""
    return cbs_level_cuda.tier_widths(Tmax)


def _batches(max_levels: int):
    """Levels a replay batch: 4, 8, 16, ... up to max_levels in all."""
    size, done = _FIRST_BATCH, 0
    while done < max_levels:
        yield min(size, max_levels - done)
        done += size
        size *= 2


# ---------------------------------------------------------------------------
# Split-location edge tests (ChangePoint.cs:359-398 / CBSTStatistic.TPermP)
# ---------------------------------------------------------------------------

def _edge_tests(x, n, i1, i2, test_both, key0, seg_c, seg_lo, alpha,
                n_perm, Tmax):
    """(keep1, keep2, edge chunks) for rows whose split needs its edges
    validated, as a level runs them (K15 around K8), on their own: the
    lanes (cbs_level_cuda.edge_lanes_plain), the lanes' chunk loops
    (kernel K8, cbs_mega_cuda.edge_counts; row r's key is
    fold_in(fold_in(fold_in(key0, seg_c[r]), seg_lo[r]), n[r])), and each
    lane's keep flag (edge_keep_plain, keep1 and keep2 of the tested
    rows)."""
    lanes = cbs_level_cuda.edge_lanes_plain(x, n, i1, i2, test_both, alpha,
                                            n_perm, Tmax)
    count, cnt = cbs_mega_cuda.edge_counts(
        lanes["xw"], lanes["wn"], lanes["m1"], lanes["xbar"],
        lanes["ostat_e"], lanes["active"], key0, seg_c, seg_lo, n,
        lanes["limit"], n_perm)
    keep = cbs_level_cuda.edge_keep_plain(
        count, cnt, lanes["degen"], lanes["quick0"], test_both, i1, i2, n,
        alpha, n_perm)
    return keep["keep1"], keep["keep2"], keep["echunks"]


# ---------------------------------------------------------------------------
# The recursion
# ---------------------------------------------------------------------------

def _launch_dicts() -> tuple[dict, ...]:
    return (arc_scan_cuda.LAUNCHES, cbs_stats_cuda.LAUNCHES,
            cbs_mega_cuda.LAUNCHES, cbs_level_cuda.LAUNCHES)


class _Engine:
    """One shape's device buffers: the inputs, the segment table with its
    control words (cbs_level_cuda's layout), the level's tensors, and on
    the card the captured level."""

    def __init__(self, dev, C, Tmax, S, W, n_sbdry, al0, kmax, n_min,
                 n_grid, n_perm, max_levels):
        self.shape = (C, Tmax, S, W, n_sbdry, al0, kmax, n_min, n_grid,
                      n_perm, max_levels)
        self.dev, self.C, self.Tmax, self.S, self.W = dev, C, Tmax, S, W
        self.al0, self.kmax, self.n_min = al0, kmax, n_min
        self.n_grid, self.n_perm, self.max_levels = n_grid, n_perm, max_levels
        self.tiers = _tiers(Tmax)
        self.contigs = torch.zeros((C, Tmax), dtype=torch.float32, device=dev)
        self.sbdry = torch.zeros(n_sbdry, dtype=torch.int64, device=dev)
        self.key0 = torch.zeros(2, dtype=torch.int64, device=dev)
        self.alpha = torch.zeros((), dtype=torch.float32, device=dev)
        self.tab = torch.zeros(3 * S + CTL, dtype=torch.int64, device=dev)
        self.pending0 = torch.zeros(S, dtype=torch.bool, device=dev)
        self.live = self.tab[3 * S + LIVE]
        self.lv = cbs_level_cuda.level_buffers(W, Tmax, len(self.tiers), dev)
        self.graph = None
        self.launches = None          # per dict of _launch_dicts: a level's
        self.nodes = None             # the captured level's, by type
        self.capture_s = None
        self.lock = threading.Lock()

    def level(self) -> None:
        """One level of the recursion: K13, the tiers' K9, B4 and K10
        (each under its row mask), K11 carrying K14, K7, K15, K8, then
        K15's keep flags with K16."""
        lv, tab, S, live = self.lv, self.tab, self.S, self.live
        cl = cbs_level_cuda
        cl.prologue(self.contigs, tab, self.pending0, lv, self.al0)
        for t, w in enumerate(self.tiers):
            tmax_batch(lv["cs"][:, :w], lv["n_eff"], lv["tss"], w, self.al0,
                       mask=lv["in_tier"][t],
                       out=(lv["t2"], lv["ti"], lv["tj"]), live=live)
        # --- the tail probability and the decision rules (K11 with K14) ---
        cl.tail_decide(tab, S, lv, self.alpha, self.kmax, self.n_grid,
                       self.n_perm, self.n_min)
        # --- sequential-stopping permutation walks (kernel K7); a walking
        # row is analysable, so its n_eff is its n and its key the chain
        # of (contig, lo, n) ---
        walked, wchunks = cbs_mega_cuda.walk(
            lv["x"], lv["n_eff"], lv["tss"], self.key0, lv["contig"],
            lv["seg_lo"], lv["needs"], lv["hybrid"], lv["ostat"],
            lv["nrejc"], self.sbdry, self.n_perm, self.al0, self.kmax,
            self.n_min, live=live)
        # --- split-location edge tests (K15, kernel K8) ---
        cl.edge_setup(tab, S, lv, walked, self.alpha, self.n_perm)
        count, cnt = cbs_mega_cuda.edge_counts(
            lv["xw"], lv["wn"], lv["m1"], lv["xbar"], lv["ostat_e"],
            lv["active"], self.key0, lv["contig"], lv["seg_lo"], lv["n"],
            lv["limit"], self.n_perm, live=live)
        # --- the keep flags and the segment-table update (K15, K16) ---
        cl.keep_table(tab, self.pending0, lv, count, cnt, walked, wchunks,
                      self.alpha, self.n_perm, self.max_levels)

    def capture(self) -> None:
        """Capture one level in a CUDA graph.  A dead level (live 0) first
        runs every wrapper's set-up eagerly (libraries, launch grids, the
        per-device state), its kernels returning at once; the capture
        launches nothing, so its launch counts move to the graph's
        (self.launches) and each replay adds them.  The capture makes no
        copy and no host read (either would make it raise); the wrappers'
        scratch and outputs come from the graph's private memory pool,
        allocated once here and kept for every replay, so a replay
        allocates nothing.  chip_smoke.py holds the launches that replays
        add against the kernels a trace of the run shows on the card."""
        t0 = time.perf_counter()
        self.tab.zero_()
        self.level()
        before = [dict(d) for d in _launch_dicts()]
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph):
            self.level()
        self.launches = []
        for d, b in zip(_launch_dicts(), before):
            self.launches.append({k: d[k] - b[k] for k in d})
            d.update(b)
        self.nodes = cbs_level_cuda.graph_nodes(graph)
        # K7, K8 and K11 run grid-wide barriers: their nodes must keep the
        # cooperative launch
        if self.nodes["cooperative"] != 3:
            raise RuntimeError(f"the captured CBS level has "
                               f"{self.nodes['cooperative']} cooperative "
                               f"kernel nodes, not K7's, K8's and K11's")
        graph.instantiate()
        torch.cuda.synchronize(self.dev)
        self.graph = graph
        self.capture_s = time.perf_counter() - t0
        GRAPHS["captures"] += 1

    def launches_a_level(self) -> dict:
        """The captured level's kernel launches by the wrappers' LAUNCHES
        names (K13 counts two)."""
        return {k: v for d in self.launches for k, v in d.items() if v}

    def replay(self) -> None:
        self.graph.replay()
        GRAPHS["replays"] += 1
        for d, add in zip(_launch_dicts(), self.launches):
            for k, v in add.items():
                d[k] += v

    def start(self, mat, n_c, sbdry, key0, alpha: float) -> None:
        """The run's set-up (the span "engine.start"): the inputs copied to
        the device (four copies) and the table's first state, a slot a
        contig."""
        S, C = self.S, self.C
        with span("engine.start"):
            self.contigs.copy_(torch.as_tensor(mat))
            self.sbdry.copy_(torch.as_tensor(sbdry))
            self.key0.copy_(torch.as_tensor(key0))
            self.alpha.fill_(alpha)
            slot = torch.arange(S, device=self.dev)
            self.tab.zero_()
            self.tab[:S].copy_(torch.where(slot < C, slot, -1))
            seg_hi0 = self.tab[2 * S:3 * S]
            seg_hi0[:C].copy_(torch.as_tensor(n_c))
            self.pending0.copy_((slot < C) & (seg_hi0 > 0))
            self.tab[3 * S + NSEG].fill_(C)
            self.live.copy_(self.pending0.any())

    def run(self, mat, n_c, sbdry, key0, alpha: float,
            graph: bool) -> list[int]:
        """The recursion over the contig matrix mat [C, Tmax] with lengths
        n_c: the set-up (four copies to the device), then levels until a
        read finds live 0, each batch of them the span "engine.batch".
        Returns that read: the table and its control words."""
        on_card = self.dev.type == "cuda"
        S = self.S
        with self.lock, (torch.cuda.device(self.dev) if on_card
                         else nullcontext()):
            if graph and self.graph is None:
                self.capture()
            self.start(mat, n_c, sbdry, key0, alpha)
            sizes = _batches(self.max_levels) if on_card \
                else [1] * self.max_levels
            for size in sizes:
                with span("engine.batch"):
                    for _ in range(size):
                        if graph:
                            self.replay()
                        else:
                            self.level()
                out = _read(self.tab)
                if not out[3 * S + LIVE]:
                    break
            return out


_ENGINES: dict = {}
_ENGINES_LOCK = threading.Lock()


def _engine(dev, *shape) -> _Engine:
    """The device's engine, made anew (and on the card captured anew)
    when the shape differs from the last run's: one engine a device, so
    one shape's buffers and graph stay on the card between runs (PERF.md
    section 5 gives their size at the largest shape)."""
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    with _ENGINES_LOCK:
        eng = _ENGINES.get(dev)
        if eng is None or eng.shape != shape:
            _ENGINES.pop(dev, None)       # the old shape's buffers go
            eng = _ENGINES[dev] = _Engine(dev, *shape)
        return eng


def _mega_recurse(mat, n_c, sbdry, key0, alpha, *, device, S, Tmax, al0,
                  kmax, n_min, n_grid, n_perm, counts, graph=True):
    """The full CBS recursion on `device` over the contig matrix mat f32
    [C, Tmax] (numpy) with lengths n_c.  Returns (seg_c, seg_lo, seg_hi,
    nseg, overflow) on the host; `counts` gains the levels and the device's
    tally (TALLY_WORDS), and WORK the run, its walk chunks and arc pairs.
    On the card the levels are replays of the captured level, a read after
    each batch; graph=False runs them eagerly (tests and chip_smoke.py call
    run_cbs_mega with this function so bound, to compare the two and to
    see each level's kernel inputs)."""
    C = mat.shape[0]
    W = min(S, max(32, S // 2))   # frontier rows analysed an iteration
    on_card = device.type == "cuda"
    eng = _engine(device, C, Tmax, S, W, len(sbdry), al0, kmax, n_min,
                  n_grid, n_perm, _MAX_LEVELS)
    out = eng.run(mat, n_c, sbdry, key0, alpha, graph and on_card)
    ctl = out[3 * S:]
    level = ctl[LEVEL]
    counts["levels"] += level
    tally = dict(zip(TALLY_WORDS, ctl[TALLY:]))
    for k, v in tally.items():
        counts[k] += v
    WORK["calls"] += 1
    WORK["walk_chunks"] += tally["walk_chunks"]
    WORK["arc_pairs"] += tally["arc_pairs"]
    return (np.asarray(out[:S]), np.asarray(out[S:2 * S]),
            np.asarray(out[2 * S:3 * S]), ctl[NSEG],
            bool(ctl[OVERFLOW]) or level >= _MAX_LEVELS)


# ---------------------------------------------------------------------------
# Host wrapper
# ---------------------------------------------------------------------------

def _pow2(v: int, floor: int = 8) -> int:
    return max(floor, 1 << (int(v) - 1).bit_length())


def run_cbs_mega(
    coverage_by_contig: dict[str, np.ndarray],
    alpha: float = _cbs.DEFAULT_ALPHA,
    n_perm: int = _cbs.DEFAULT_NPERM,
    undo_method: str = "none",
    seed: int = 0,
    p_method: str = "hybrid",
    min_width: int = _cbs.DEFAULT_MIN_WIDTH,
    kmax: int = _cbs.DEFAULT_KMAX,
    n_min: int = _cbs.DEFAULT_NMIN,
    undo_prune: float = 0.05,
    undo_sd: float = 3.0,
    device: str | torch.device = "cuda",
    counts: dict | None = None,
) -> dict[str, np.ndarray] | None:
    """CBSRunner.Run with the whole recursion on `device` (module
    docstring).  Same contract as ops.cbs.run_cbs: contig -> segment
    lengths.  Returns None when the input does not fit the table (more
    than 65,536 bins in a contig, more than 192 contigs, more segments
    than the table holds, or the level bound reached); the caller then
    runs the frontier engine.  With `counts` given, it gains the run's
    levels and the device's tally: walks accepted and rejected, walk
    chunks, edge-test chunks and arc pairs.  Asking for a missing card
    raises.  On the card the levels are replays of a captured level.  The
    phases are spans of a torch profiler's trace: "cbs.prepare" (the
    rows, sizes, boundary and contig matrix), the engine's "engine.start",
    "engine.batch" and "engine.read", then "cbs.assemble"."""
    with span("cbs.prepare"):
        device = resolve_device(device)
        names = list(coverage_by_contig)
        rows = [np.asarray(coverage_by_contig[k], np.float64) for k in names]
        if sum(len(r) for r in rows) == 0:
            return {}
        nonempty = [c for c, r in enumerate(rows) if len(r)]
        max_len = max(len(rows[c]) for c in nonempty)
        C = len(nonempty)
        if max_len > _MAX_BINS or C > _MAX_CONTIGS:
            return None

        Tmax = _pow2(max_len, floor=1024)
        S = _pow2(max(_MIN_SLOTS, 4 * C))
        sbdry = np.asarray(_cbs.compute_boundary(n_perm, alpha,
                                                 _cbs.DEFAULT_ETA), np.int64)
        if undo_method == "sdundo":
            finite = {k: np.asarray(v, np.float64)[np.isfinite(v)]
                      for k, v in coverage_by_contig.items()}
            tsd = float(np.sqrt(_cbs.trimmed_variance(finite))) \
                if any(len(v) for v in finite.values()) else 0.0
        else:
            tsd = 0.0

        mat = np.zeros((C, Tmax), np.float32)
        n_c = np.zeros(C, np.int64)
        for i, c in enumerate(nonempty):
            mat[i, : len(rows[c])] = rows[c]
            n_c[i] = len(rows[c])
        key0 = np.asarray([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                          np.int64)     # jax.random.PRNGKey(seed)
    run_counts = dict.fromkeys(("levels",) + TALLY_WORDS, 0)
    seg_c, seg_lo, seg_hi, nseg, overflow = _mega_recurse(
        mat, n_c, sbdry, key0, alpha, device=device,
        S=S, Tmax=Tmax, al0=min_width, kmax=kmax,
        n_min=n_min if p_method == "hybrid" else (1 << 30),
        n_grid=100, n_perm=n_perm, counts=run_counts)
    if counts is not None:
        for k, v in run_counts.items():
            counts[k] = counts.get(k, 0) + v
    if overflow:
        return None

    with span("cbs.assemble"):
        # assemble leaves -> per-contig lengths; validate the partition
        result: dict[str, np.ndarray] = {}
        for i, c in enumerate(nonempty):
            sel = seg_c[:nseg] == i
            los = np.sort(seg_lo[:nseg][sel])
            his = np.sort(seg_hi[:nseg][sel])
            n = len(rows[c])
            if (len(los) == 0 or los[0] != 0 or his[-1] != n
                    or np.any(los[1:] != his[:-1])):
                raise RuntimeError(f"cbs_mega: the segment table of contig "
                                   f"{names[c]} does not tile [0, {n})")
            lengths = (his - los).astype(np.int64)
            if len(lengths) > 1 and undo_method == "prune":
                lengths = _cbs._prune(rows[c], lengths, undo_prune)
            elif len(lengths) > 1 and undo_method == "sdundo":
                lengths = _cbs._sd_undo(rows[c], lengths, tsd, undo_sd)
            result[names[c]] = np.asarray(lengths, np.int64)
        # the frontier engine's empty-contig convention: lengths [0] for n == 0
        for name in names:
            if name not in result:
                result[name] = np.asarray([0], np.int64)
    return result
