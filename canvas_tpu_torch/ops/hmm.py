"""5-state negative-binomial HMM segmentation (CanvasPartition PerSampleHMM
and the joint multi-sample HMM).

Reference semantics (CanvasPartition/HMM.cs, HiddenMarkovModelsRunner.cs,
Distributions.cs):

  * states = copy numbers 0..4; self-transition 0.99, off 0.0025 (HMM.cs:16);
  * emissions: per-sample negative-binomial lookup tables with
    mean = max(CN, 0.1) * haploidMean and a shared genome-wide variance
    (HiddenMarkovModelsRunner.cs:111-152); haploidMean = median/2 (per-sample
    mode uses genome-wide median and IQR^2 pseudo-variance);
  * data clamped at max(haploidMean)*nStates before table build (:154-162);
  * table indices are Convert.ToInt32 = round-half-even of the coverage;
  * the multivariate "genotype permutation" emission takes the max over
    assignments of each sample to state CN or diploid (Distributions.cs:
    257-297), with states {0,1} and {3,4} sharing a per-factor max when
    useAllStates=false (the joint HMM);
  * the transition cost reduces to transition[prev][cur], so decode is a
    standard time-varying-emission Viterbi.

Decode: the chunked Viterbi.  T splits into T/chunk chunks, one lane per
chunk of each sequence; kernel B2 folds each chunk into a (max,+) transfer
matrix, kernel K5 scans the chunks in order for the chunk-start scores,
kernel B3 recomputes each chunk's DP with backpointers and backtracks all
S assumed chunk-end states, and kernel K6 chases the chunk-end states that
pick the realized path (ops/viterbi_cuda.py holds the kernels' wrappers).
On a CUDA device that is six launches and no read back to the host.
"""

from __future__ import annotations

from itertools import permutations as _permutations

import numpy as np
import torch

from canvas_tpu_torch.config import resolve_device
from canvas_tpu_torch.ops import stats, viterbi_cuda
from canvas_tpu_torch.parallel.mesh import lane_devices, split_lanes

N_STATES = 5
SELF_TRANSITION = 0.99
NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Negative-binomial density tables (Distributions.cs:206-217)
# ---------------------------------------------------------------------------

def negative_binomial_table(mean, variance, max_value: int) -> np.ndarray:
    """Density table [.., max_value] with the reference's exact formula.

    Built on host in float64 (the tables are tiny — S x D x V entries — and
    the reference computes them in C# doubles)."""
    from scipy.special import gammaln as np_gammaln, xlogy

    mean = np.asarray(mean, dtype=np.float64)
    var = np.maximum(np.asarray(variance, dtype=np.float64), mean * 1.2)
    r = np.maximum(mean, 0.1) ** 2 / (var - mean)
    x = np.arange(max_value, dtype=np.float64)
    mean_, r_ = mean[..., None], r[..., None]
    with np.errstate(divide="ignore", invalid="ignore"):
        # xlogy keeps the x=0 term at 0 when mean==0 (0^0 = 1 in the
        # reference's Math.Pow), instead of 0 * -inf = NaN
        logp = (
            -r_ * np.log1p(mean_ / r_)
            + xlogy(x, mean_) - x * np.log(mean_ + r_)
            + np_gammaln(r_ + x)
            - np_gammaln(x + 1.0)
            - np_gammaln(r_)
        )
        dens = np.exp(logp)
    return np.where(np.isfinite(dens), dens, 0.0)


def multivariate_poisson_likelihood(means, x) -> float:
    """MultivariatePoissonDistribution.EstimateLikelihood
    (CanvasPartition/Distributions.cs:79-114): product of independent
    Poisson pmfs over the samples axis, with the reference's NaN/Inf ->
    0.0 guard (so extreme counts underflow to a hard zero instead of
    propagating non-finite values into the mixture).  The reference keeps
    this as the alternative HMM emission next to the production
    NegativeBinomialMixture (HMM.cs:30)."""
    from scipy import stats as _sps

    means = np.asarray(means, dtype=np.float64)
    counts = np.rint(np.asarray(x, dtype=np.float64)).astype(np.int64)
    with np.errstate(over="ignore", invalid="ignore"):
        lik = float(np.prod(_sps.poisson.pmf(counts, means)))
    return lik if np.isfinite(lik) else 0.0


def genotype_combinations(n_dim: int, state: int) -> list[tuple[int, ...]]:
    """DistributionUtilities.GetGenotypeCombinations (Distributions.cs:187-204):
    distinct permutations of (state × (n-k), 2 × k) for k in 0..n-1."""
    combos: list[tuple[int, ...]] = []
    seen = set()
    for k in range(n_dim):
        base = (state,) * (n_dim - k) + (2,) * k
        for p in sorted(set(_permutations(base))):
            if p not in seen:
                seen.add(p)
                combos.append(p)
    return combos


def build_emission_tables(
    coverage: np.ndarray,      # [T, D] per-bin coverage for D samples
    n_states: int = N_STATES,
    medians: np.ndarray | None = None,
    pseudo_variances: np.ndarray | None = None,
):
    """Initialize NB tables (HiddenMarkovModelsRunner.cs:111-152).

    Returns (tables [S, D, V], haploid_means [D], clamped coverage [T, D]).
    When `medians`/`pseudo_variances` are given (per-sample mode) they are the
    genome-wide median and IQR^2; otherwise the per-chromosome median and
    sample variance are used (joint HMM mode).
    """
    cov = np.asarray(coverage, dtype=np.float64)
    T, D = cov.shape
    haploid = np.empty(D)
    var = np.empty(D)
    for d in range(D):
        med = max(1.0, stats.median(cov[:, d]))
        if medians is None:
            haploid[d] = med / 2.0
            var[d] = stats.variance(cov[:, d])
        else:
            haploid[d] = medians[d] / 2.0
            var[d] = pseudo_variances[d]
    max_threshold = haploid.max() * n_states
    cov = np.minimum(cov, max_threshold)
    max_value = int(cov.max()) + 10
    means = np.maximum(np.arange(n_states)[:, None], 0.1) * haploid[None, :]
    tables = negative_binomial_table(
        means, np.broadcast_to(var, means.shape), max_value)
    return tables, haploid, cov


def _log_tables(tables: np.ndarray) -> np.ndarray:
    """log of the NB densities in float64 (tiny densities stay
    representable), NEG_INF where a density is 0."""
    return np.where(np.asarray(tables) > 0,
                    np.log(np.maximum(np.asarray(tables, np.float64),
                                      1e-300)), NEG_INF)


def emission_log_probs(
    coverage: torch.Tensor,  # [B, T, D] f32 (clamped)
    tables,                  # [S, D, V] densities, host float64
    mask: torch.Tensor,      # [B, T] bool
    use_all_states: bool = True,
) -> torch.Tensor:
    """log max-over-genotype emission [B, T, S] on coverage's device.

    Factorizes over samples: log em(j) = max_g sum_d log f(g_d, d, x_d) with
    g ranging over genotype_combinations(D, j).  Each factor is a gather of
    the float32 log table at round-half-even(x_d); the factors of a genotype
    add in sample order ((f0 + f1) + f2), then the max over genotypes.  That
    is canvas_tpu's one-hot contraction bit for bit (each one-hot row selects
    one entry, and NEG_INF is finite), on every device: a gather, adds in a
    fixed order and maxima are exact IEEE operations."""
    logt = torch.as_tensor(_log_tables(tables).astype(np.float32),
                           device=coverage.device)
    return emissions_from_log_tables(coverage, logt, mask, use_all_states)


def emissions_from_log_tables(
    coverage: torch.Tensor,  # [B, T, D] f32 (clamped)
    logt: torch.Tensor,      # [S, D, V] f32 log densities, NEG_INF for 0
    mask: torch.Tensor,      # [B, T] bool
    use_all_states: bool = True,
) -> torch.Tensor:
    """emission_log_probs from log tables already on coverage's device."""
    S, D, V = logt.shape
    dev = coverage.device
    if not use_all_states:
        # joint-HMM grouped per-factor max (Distributions.cs:278-285)
        g01 = torch.maximum(logt[0], logt[1])
        g34 = torch.maximum(logt[3], logt[4])
        logt = torch.stack([g01, g01, logt[2], g34, g34])
    idx = torch.clamp(torch.round(coverage).to(torch.int64), 0, V - 1)
    # factor[s, b, t, d] = logt[s, d, idx[b, t, d]]
    d_idx = torch.arange(D, device=dev).expand_as(idx)
    factor = logt[:, d_idx, idx]                              # [S,B,T,D]
    ems = []
    for j in range(S):
        geno = genotype_combinations(D, j)                    # [G][D]
        acc = torch.stack([factor[g[0], ..., 0] for g in geno], dim=-1)
        for d in range(1, D):
            acc = acc + torch.stack([factor[g[d], ..., d] for g in geno],
                                    dim=-1)
        ems.append(acc.amax(dim=-1))                          # [B, T]
    em = torch.stack(ems, dim=-1)                             # [B, T, S]
    return torch.where(mask[..., None], em,
                       torch.zeros((), dtype=em.dtype, device=dev))


def _emission_log_probs_np(cov: np.ndarray, tables: np.ndarray,
                           use_all_states: bool) -> np.ndarray:
    """Host float64 oracle of emission_log_probs for one contig:
    [T, D] -> [T, S] (genotype-permutation max, Distributions.cs:257-297)."""
    S, D, V = tables.shape
    logt = _log_tables(tables)
    if not use_all_states:
        g01 = np.maximum(logt[0], logt[1])
        g34 = np.maximum(logt[3], logt[4])
        logt = logt.copy()
        logt[0] = logt[1] = g01
        logt[3] = logt[4] = g34
    idx = np.clip(np.rint(cov).astype(np.int64), 0, V - 1)      # [T, D]
    T = idx.shape[0]
    factor = np.empty((T, S, D))                                # [T, S, D]
    for d in range(D):
        factor[:, :, d] = logt[:, d, idx[:, d]].T
    ems = []
    for j in range(S):
        combos = np.array(genotype_combinations(D, j))           # [G, D]
        f = factor[:, combos, np.arange(D)[None]]                # [T, G, D]
        ems.append(f.sum(axis=-1).max(axis=-1))
    return np.stack(ems, axis=-1)                                # [T, S]


def log_transition(n_states: int = N_STATES, self_p: float = SELF_TRANSITION):
    off = (1.0 - self_p) / (n_states - 1)
    t = np.full((n_states, n_states), off)
    np.fill_diagonal(t, self_p)
    # host array: the kernels take it as an argument, the numpy oracles
    # use it as it is
    return np.log(t).astype(np.float32)


# ---------------------------------------------------------------------------
# Viterbi decode — chunked, the production path
# ---------------------------------------------------------------------------

def prefix_lengths(mask) -> np.ndarray:
    """Each row's length, int32 [B], from a host mask (numpy or a CPU
    tensor) [B, T] whose rows are True prefixes (padded tails); raises
    ValueError for any other mask."""
    m = np.asarray(mask.numpy() if torch.is_tensor(mask) else mask,
                   dtype=bool)
    lengths = m.sum(axis=1).astype(np.int32)
    if not np.array_equal(np.arange(m.shape[1])[None, :] < lengths[:, None],
                          m):
        raise ValueError("viterbi_decode_chunked needs prefix masks")
    return lengths


def viterbi_decode_chunked(
    log_em: torch.Tensor,   # [B, T, S] f32
    mask: torch.Tensor,     # [B, T] bool; a True prefix per row
    log_trans,              # [S, S] host array
    log_init,               # [S] host array
    chunk: int = 256,
    plain: bool = False,
    lengths=None,           # [B] host ints: the rows' prefix lengths
) -> torch.Tensor:
    """Chunked parallel Viterbi: most-likely state path [B, T] (int32),
    decision-identical to canvas_tpu's viterbi_decode_chunked (and to its
    numpy transcription here, viterbi_decode_np_chunked).

      1. per-chunk (max,+) transfer matrices (kernel B2);
      2. the (max,+) prefix over each sequence's chunks, bracketed as
         canvas_tpu's associative scan (jax.lax.associative_scan) brackets
         it, gives the chunk-start scores and the best last end state
         (kernel K5);
      3+4a. per-chunk forward DP with backpointers and the backtrack of all
         S assumed chunk-end states (kernel B3);
      4b. the chunk-end states, composed right to left by pointer
         doubling (kernel K6), select each chunk's realized path (a
         gather in int8).

    All in-chunk state is lane-last ([S, L] and [S, S, L] with
    L = B * n_chunks).  Masks must be prefix masks (padded tails): each
    lane's step masks are rebuilt from its chunk start and the row length.
    A mask on the CPU is checked here.  On a CUDA device the decode is a
    fixed sequence of launches that reads nothing back to the host, so
    the caller checks its host mask with prefix_lengths and passes the
    lengths in (ValueError without them); the kernels then take the row
    lengths from the mask on the card.  plain=True runs the kernels' plain
    torch versions on the tensors' device, to hold the kernels against
    them."""
    B, T, S = log_em.shape
    dev = log_em.device
    if mask.device.type == "cpu":
        host = prefix_lengths(mask)
        if lengths is not None and not np.array_equal(
                np.asarray(lengths), host):
            raise ValueError("lengths differ from the mask's prefixes")
        row_len = torch.from_numpy(host).to(dev, non_blocking=True)
    else:
        if lengths is None or np.asarray(lengths).shape != (B,):
            raise ValueError(
                "a decode on a CUDA device needs the rows' lengths from "
                "the host mask (prefix_lengths): it reads nothing back")
        row_len = mask.sum(dim=1, dtype=torch.int32)
    pad = (-T) % chunk
    if pad:
        log_em = torch.nn.functional.pad(log_em, (0, 0, 0, pad))
    Tp = T + pad
    nC = Tp // chunk
    L = B * nC

    # [B, nC, chunk, S] -> [chunk, S, B, nC] -> [chunk, S, L]
    em = log_em.to(torch.float32).reshape(B, nC, chunk, S) \
        .permute(2, 3, 0, 1).reshape(chunk, S, L).contiguous()
    # per-lane chunk-start time and sequence length (lane = b * nC + c)
    base = (torch.arange(nC, device=dev, dtype=torch.int32) * chunk).repeat(B)
    lane_len = row_len[:, None].expand(B, nC).reshape(L)

    vc = viterbi_cuda
    if plain:
        phases = (vc.chunk_matrices_plain, vc.chunk_scan_plain,
                  vc.forward_backtrack_plain, vc.chunk_chase_plain)
    else:
        phases = (vc.chunk_matrices, vc.chunk_scan, vc.forward_backtrack,
                  vc.chunk_chase)
    matrices, scan, forward_backtrack, chase = phases

    chunk_mats = matrices(em, base, lane_len, log_trans, log_init)  # [S,S,L]
    ss, last_end = scan(chunk_mats, B)                      # [S, L], [B]
    paths_all, prev_end = forward_backtrack(em, base, lane_len, ss,
                                            log_trans, log_init)
    sel = chase(prev_end, last_end)                         # [L] int64
    states = torch.gather(paths_all, 1,
                          sel.view(1, 1, L).expand(chunk, 1, L))[:, 0]
    states = states.reshape(chunk, B, nC).permute(1, 2, 0)
    return states.reshape(B, Tp)[:, :T].to(torch.int32)


def _associative_scan_np(e: np.ndarray) -> np.ndarray:
    """Inclusive (max,+) prefix over axis 1 of e [B, n, S, S] in
    jax.lax.associative_scan's recursion: pairs r[i] = e[2i] (x) e[2i+1],
    o = scan(r), then out[2i+1] = o[i], out[0] = e[0] and
    out[2i] = o[i-1] (x) e[2i]; (x) adds once a term in float32."""
    def prod(a, b):
        return (a[..., :, :, None] + b[..., None, :, :]).max(axis=-2)

    n = e.shape[1]
    if n < 2:
        return e
    o = _associative_scan_np(prod(e[:, 0:n - 1:2], e[:, 1::2]))
    out = np.empty_like(e)
    out[:, 0] = e[:, 0]
    out[:, 1::2] = o
    out[:, 2::2] = prod(o[:, :(n - 1) // 2], e[:, 2::2])
    return out


def viterbi_decode_np_chunked(log_em: np.ndarray, log_trans: np.ndarray,
                              log_init: np.ndarray, mask: np.ndarray,
                              chunk: int = 256) -> np.ndarray:
    """Pure-numpy transcription of canvas_tpu's jitted
    viterbi_decode_chunked (same math, same bracketing of the phase-2
    adds, same tie-breaking) — the host oracle the torch decode is tested
    against where canvas_tpu cannot run.
    Every phase loops only `chunk` times with all B*T/chunk chunk-lanes
    vectorized."""
    log_em = np.asarray(log_em, np.float32)
    lt = np.asarray(log_trans, np.float32)
    li = np.asarray(log_init, np.float32)
    B, T, S = log_em.shape
    pad = (-T) % chunk
    if pad:
        log_em = np.pad(log_em, ((0, 0), (0, pad), (0, 0)))
        mask = np.pad(mask, ((0, 0), (0, pad)))
    Tp = T + pad
    nC = Tp // chunk
    L = B * nC
    em = np.transpose(log_em.reshape(B, nC, chunk, S),
                      (2, 3, 0, 1)).reshape(chunk, S, L)
    mk = np.transpose(mask.reshape(B, nC, chunk), (2, 0, 1)).reshape(chunk, L)
    t_idx = np.arange(Tp).reshape(nC, chunk)
    is_t0 = np.broadcast_to((t_idx == 0).T[:, None, :],
                            (chunk, B, nC)).reshape(chunk, L)

    # phase 1: chunk transfer matrices, carry [S, S, L]
    eye = np.where(np.eye(S, dtype=bool), np.float32(0.0),
                   np.float32(NEG_INF))
    M = np.broadcast_to(eye[..., None], (S, S, L)).astype(np.float32).copy()
    for k in range(chunk):
        e, m, t0 = em[k], mk[k], is_t0[k]
        # acc[i,j] = max_k M[i,k] + lt[k,j]
        acc = (M[:, :, None, :] + lt[None, :, :, None]).max(axis=1)
        reg = acc + e[None, :, :]
        t0v = np.broadcast_to((li[:, None] + e)[None], (S, S, L))
        M = np.where(m[None, None], np.where(t0[None, None], t0v, reg), M)

    # phase 2: prefix (max,+) products over chunks, bracketed as
    # jax.lax.associative_scan brackets them -> chunk-end and chunk-start
    # score vectors
    cm = np.transpose(M.reshape(S, S, B, nC), (2, 3, 0, 1))   # [B,nC,S,S]
    scores_end = _associative_scan_np(cm).max(axis=-2)        # [B, nC, S]
    start_scores = np.concatenate(
        [np.zeros((B, 1, S), np.float32), scores_end[:, :-1]], axis=1)
    ss = np.transpose(start_scores, (2, 0, 1)).reshape(S, L)

    # phase 3: in-chunk forward with backpointers, carry [S, L]
    j_iota = np.broadcast_to(np.arange(S, dtype=np.int32)[:, None], (S, L))
    bps = np.empty((chunk, S, L), np.int8)
    carry = ss.astype(np.float32).copy()
    for k in range(chunk):
        e, m, t0 = em[k], mk[k], is_t0[k]
        cand = carry[:, None, :] + lt[:, :, None]             # [i, j, L]
        acc = cand.max(axis=0)
        arg = cand.argmax(axis=0).astype(np.int32)            # first max
        reg = acc + e
        t0v = li[:, None] + e
        carry = np.where(m, np.where(t0, t0v, reg), carry)
        bps[k] = np.where(m & ~t0, arg, j_iota).astype(np.int8)

    # phase 4a: backtrack all S assumed chunk-end states
    state = np.broadcast_to(np.arange(S, dtype=np.int32)[:, None],
                            (S, L)).copy()
    paths_all = np.empty((chunk, S, L), np.int8)
    for k in range(chunk - 1, 0, -1):
        paths_all[k] = state
        state = np.take_along_axis(bps[k].astype(np.int32), state, axis=0)
    paths_all[0] = state
    prev_end = np.take_along_axis(bps[0].astype(np.int32), state, axis=0)

    # phase 4b: resolve chunk-end states right-to-left
    last_end = scores_end[:, -1].argmax(axis=-1).astype(np.int32)   # [B]
    pe = np.transpose(prev_end.reshape(S, B, nC), (2, 1, 0))        # [nC,B,S]
    ces = np.empty((nC, B), np.int32)
    cur = last_end
    rows = np.arange(B)
    for c in range(nC - 1, -1, -1):
        ces[c] = cur
        cur = pe[c, rows, cur]
    sel = ces.T.reshape(1, 1, L)                                    # [B,nC]

    states = np.take_along_axis(paths_all.astype(np.int32), sel, axis=1)[:, 0]
    states = np.transpose(states.reshape(chunk, B, nC), (1, 2, 0))
    return states.reshape(B, Tp)[:, :T].astype(np.int32)


def viterbi_decode_np(log_em: np.ndarray, log_trans: np.ndarray,
                      log_init: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Pure-numpy sequential Viterbi (float32 DP, first-max argmax
    tie-breaking), O(T) depth — the dependency-free semantics oracle."""
    log_em = np.asarray(log_em, np.float32)
    log_trans = np.asarray(log_trans, np.float32)
    log_init = np.asarray(log_init, np.float32)
    B, T, S = log_em.shape
    score = np.where(mask[:, 0, None], log_init[None] + log_em[:, 0],
                     np.zeros((B, S), np.float32)).astype(np.float32)
    bps = np.empty((B, T - 1, S), np.int32) if T > 1 else \
        np.empty((B, 0, S), np.int32)
    stay = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))
    for t in range(1, T):
        cand = score[:, :, None] + log_trans[None]          # [B,S,S]
        best = cand.max(axis=1) + log_em[:, t]
        bp = cand.argmax(axis=1).astype(np.int32)
        m = mask[:, t, None]
        score = np.where(m, best, score).astype(np.float32)
        bps[:, t - 1] = np.where(m, bp, stay)
    path = np.empty((B, T), np.int32)
    state = score.argmax(axis=-1).astype(np.int32)
    path[:, T - 1] = state
    for t in range(T - 2, -1, -1):
        state = bps[np.arange(B), t, state]
        path[:, t] = state
    return path


# ---------------------------------------------------------------------------
# High-level per-contig segmentation (HiddenMarkovModelsRunner.Run)
# ---------------------------------------------------------------------------

def breakpoints_from_path(path: np.ndarray) -> list[int]:
    """Indices where the Viterbi state changes, 0-prefixed
    (HiddenMarkovModelsRunner.cs:88-95)."""
    bps = [0]
    diff = np.flatnonzero(np.diff(path)) + 1
    bps.extend(int(i) for i in diff)
    return bps


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def _batched_inputs(coverage_by_contig, n_states, min_size, min_lanes=1):
    """The host half of the PerSampleHMM decode's inputs: (live contig
    names, their lengths, coverage f32 [B, T] clamped at the table's top,
    mask bool [B, T], log table f32 [S, V], log_trans [S, S], log_init
    [S]); coverage, mask and table are None when no contig is live.  B is
    at least next_pow2(min_lanes), as canvas_tpu pads lanes to the device
    count."""
    names = list(coverage_by_contig)
    lengths = {n: len(np.atleast_1d(coverage_by_contig[n]).squeeze())
               for n in names}
    live = [n for n in names if lengths[n] > min_size]
    log_trans = np.asarray(log_transition(n_states), np.float32)
    log_init = np.log(np.full(n_states, 1.0 / n_states, np.float32))
    if not live:
        return live, lengths, None, None, None, log_trans, log_init

    allcov = np.concatenate(
        [np.asarray(coverage_by_contig[n], np.float64).reshape(-1)
         for n in live])
    q = stats.quartiles(allcov.astype(np.float32))
    median = q[1]
    pseudo_var = (q[2] - q[0]) ** 2
    tables, _, _ = build_emission_tables(
        allcov[:, None], n_states, np.array([median]), np.array([pseudo_var]))
    max_threshold = median / 2.0 * n_states

    T = _next_pow2(max(lengths[n] for n in live))
    B = max(_next_pow2(len(live)), _next_pow2(min_lanes))
    cov = np.zeros((B, T), dtype=np.float32)
    mask = np.zeros((B, T), dtype=bool)
    for b, n in enumerate(live):
        c = np.minimum(np.asarray(coverage_by_contig[n],
                                  np.float64).reshape(-1), max_threshold)
        cov[b, :lengths[n]] = c
        mask[b, :lengths[n]] = True

    logt = np.asarray(_log_tables(tables)[:, 0, :], np.float32)  # [S, V]
    return live, lengths, cov, mask, logt, log_trans, log_init


def _lookup_emissions(cov: torch.Tensor, mask: torch.Tensor,
                      logt: torch.Tensor) -> torch.Tensor:
    """log_em f32 [B, T, S] on cov's device: the log table [S, V] at the
    round-half-even of each bin's coverage (Convert.ToInt32; torch.round
    rounds half to even like np.rint), 0 where the mask is False."""
    V = logt.shape[1]
    idx = torch.clamp(torch.round(cov).to(torch.int64), 0, V - 1)
    return torch.where(mask[..., None], logt.T[idx],
                       torch.zeros((), dtype=torch.float32,
                                   device=cov.device))


def batched_emissions(
    coverage_by_contig: dict[str, np.ndarray],  # contig -> [T_c] (one sample)
    n_states: int = N_STATES,
    min_size: int = 10,
    device: str | torch.device = "cuda",
):
    """The PerSampleHMM decode's inputs for all contigs of one sample.

    In PerSampleHMM mode the emission tables derive from genome-wide
    statistics (HiddenMarkovModelsRunner.cs:36-50), so every contig shares
    one table set and contigs batch as padded lanes of a single Viterbi
    decode (prefix masks).  B and T are padded to powers of two, as in
    canvas_tpu (padding lanes have all-False masks).

    Returns (live contig names, their lengths, log_em f32 [B, T, S] and
    mask bool [B, T] on `device`, log_trans [S, S], log_init [S]); live is
    empty when no contig has more than min_size bins.  Asking for a
    missing card raises."""
    dev = resolve_device(device)
    live, lengths, cov, mask, logt, log_trans, log_init = _batched_inputs(
        coverage_by_contig, n_states, min_size)
    if not live:
        return live, lengths, None, None, log_trans, log_init
    mask_t = torch.as_tensor(mask, device=dev)
    log_em = _lookup_emissions(torch.as_tensor(cov, device=dev), mask_t,
                               torch.as_tensor(logt, device=dev))
    return live, lengths, log_em, mask_t, log_trans, log_init


def _lane_lengths(live, lengths, n_lanes) -> np.ndarray:
    """Host int32 [n_lanes]: each live contig's length in lane order, 0 for
    the padding lanes; the prefix lengths of the masks built from them."""
    out = np.zeros(n_lanes, np.int32)
    out[:len(live)] = [lengths[n] for n in live]
    return out


def _decode_lanes(log_em_parts, mask_parts, lane_len, log_trans, log_init,
                  chunk: int) -> np.ndarray:
    """Decode each lane group on its own device, then bring the paths to
    the host in lane order.  A decode reads nothing back, so every group
    is queued before the first path is copied: groups on different cards
    run at once."""
    parts = np.split(lane_len, len(log_em_parts))
    paths = [viterbi_decode_chunked(em, m, log_trans, log_init, chunk=chunk,
                                    lengths=n)
             for em, m, n in zip(log_em_parts, mask_parts, parts)]
    return np.concatenate([p.cpu().numpy() for p in paths])


def segment_coverage_batched(
    coverage_by_contig: dict[str, np.ndarray],  # contig -> [T_c] (one sample)
    n_states: int = N_STATES,
    min_size: int = 10,
    chunk: int = 256,
    device: str | torch.device = "cuda",
    devices=None,
) -> dict[str, list[int]]:
    """Per-sample HMM over ALL contigs in one batched decode (see
    batched_emissions).  On a CUDA device the decode runs kernels B2, K5,
    B3 and K6; on the CPU their plain versions.  Returns contig -> breakpoint
    indices.  Asking for a missing card raises.

    With more than one lane device (parallel.mesh.lane_devices: every
    visible card for an unindexed "cuda", or the `devices` mesh), B is at
    least next_pow2(n) and, when n divides it, the lanes split into n
    contiguous groups: each group looks up its emissions and decodes on
    its own device, as canvas_tpu's lane-sharded decode does.  Lanes are
    independent, so no device waits for another."""
    devs = lane_devices(device, devices)
    n = len(devs)
    live, lengths, cov, mask, logt, log_trans, log_init = _batched_inputs(
        coverage_by_contig, n_states, min_size, min_lanes=n)
    out: dict[str, list[int]] = {c: [0] for c in coverage_by_contig
                                 if c not in live}
    if not live:
        return out
    groups = devs if cov.shape[0] % n == 0 else devs[:1]
    cov_p = split_lanes(torch.as_tensor(cov), groups)
    mask_p = split_lanes(torch.as_tensor(mask), groups)
    em_p = [_lookup_emissions(c, m, torch.as_tensor(logt, device=c.device))
            for c, m in zip(cov_p, mask_p)]
    paths = _decode_lanes(em_p, mask_p, prefix_lengths(mask), log_trans,
                          log_init, chunk)
    for b, c in enumerate(live):
        out[c] = breakpoints_from_path(paths[b, :lengths[c]])
    return out


def joint_emissions(
    coverage_by_contig: dict[str, np.ndarray],   # contig -> [T_c, D] or [T_c]
    n_states: int = N_STATES,
    min_size: int = 10,
    device: str | torch.device = "cuda",
    min_lanes: int = 1,
):
    """The joint multi-sample HMM decode's inputs for all contigs.

    Joint mode (HiddenMarkovModelsRunner.cs 'HMM') builds NB tables per
    contig (the contig's median and variance of each sample) and the
    grouped genotype-permutation emission, computed per contig on `device`;
    the contigs then sit as padded lanes of one [B, T, S] emission tensor,
    B and T padded to powers of two as in canvas_tpu (padding lanes have
    all-False masks), B at least next_pow2(min_lanes).  1-D coverage is
    one sample.

    Returns (live contig names, their lengths, log_em f32 [B, T, S] and
    mask bool [B, T] on `device`, log_trans [S, S], log_init [S]); live is
    empty when no contig has more than min_size bins.  Asking for a
    missing card raises."""
    dev = resolve_device(device)
    lengths = {n: np.asarray(c).shape[0]
               for n, c in coverage_by_contig.items()}
    live = [n for n in coverage_by_contig if lengths[n] > min_size]
    log_trans = log_transition(n_states)
    log_init = np.log(np.full(n_states, 1.0 / n_states, np.float32))
    if not live:
        return live, lengths, None, None, log_trans, log_init
    T = _next_pow2(max(lengths[n] for n in live))
    B = max(_next_pow2(len(live)), _next_pow2(min_lanes))
    log_em = torch.zeros((B, T, n_states), dtype=torch.float32, device=dev)
    mask = torch.zeros((B, T), dtype=torch.bool, device=dev)
    for b, n in enumerate(live):
        cov = np.asarray(coverage_by_contig[n], np.float64)
        if cov.ndim == 1:
            cov = cov[:, None]
        tables, _, clamped = build_emission_tables(cov, n_states)
        x = torch.as_tensor(clamped.astype(np.float32), device=dev)[None]
        ones = torch.ones((1, lengths[n]), dtype=torch.bool, device=dev)
        log_em[b, :lengths[n]] = emission_log_probs(
            x, tables, ones, use_all_states=False)[0]
        mask[b, :lengths[n]] = True
    return live, lengths, log_em, mask, log_trans, log_init


def segment_coverage_joint_batched(
    coverage_by_contig: dict[str, np.ndarray],   # contig -> [T_c, D] or [T_c]
    n_states: int = N_STATES,
    min_size: int = 10,
    chunk: int = 256,
    device: str | torch.device = "cuda",
    devices=None,
) -> dict[str, list[int]]:
    """Joint multi-sample HMM over ALL contigs in one batched decode (see
    joint_emissions): on a CUDA device the decode runs kernels B2, K5, B3
    and K6, on the CPU their plain versions.  Returns contig -> breakpoint
    indices.  Asking for a missing card raises.

    With more than one lane device (as in segment_coverage_batched) the
    emissions are computed on the first, then placed lane-split, each
    group decoding on its own device, as canvas_tpu places its joint
    emissions over the mesh."""
    devs = lane_devices(device, devices)
    n = len(devs)
    live, lengths, log_em, mask, log_trans, log_init = joint_emissions(
        coverage_by_contig, n_states, min_size, devs[0], min_lanes=n)
    out: dict[str, list[int]] = {c: [0] for c in coverage_by_contig
                                 if c not in live}
    if not live:
        return out
    groups = devs if log_em.shape[0] % n == 0 else devs[:1]
    em_p, mask_p = split_lanes(log_em, groups), split_lanes(mask, groups)
    paths = _decode_lanes(em_p, mask_p,
                          _lane_lengths(live, lengths, log_em.shape[0]),
                          log_trans, log_init, chunk)
    for b, c in enumerate(live):
        out[c] = breakpoints_from_path(paths[b, :lengths[c]])
    return out


def segment_coverage(
    coverage_by_contig: dict[str, np.ndarray],  # contig -> [T_c, D]
    per_sample: bool = True,
    n_states: int = N_STATES,
    min_size: int = 10,
    chunk: int = 256,
    device: str | torch.device = "cuda",
) -> dict[str, list[int]]:
    """Run the HMM over every contig, one decode a contig on `device`;
    returns contig -> breakpoint indices.

    per_sample=True mirrors PerSampleHMM (genome-wide median/IQR^2 of each
    sample, every genotype state); False mirrors the joint multi-sample HMM
    (per-contig stats, grouped emission max).  Asking for a missing card
    raises."""
    dev = resolve_device(device)
    if per_sample:
        allcov = np.concatenate(list(coverage_by_contig.values()), axis=0)
        quarts = [stats.quartiles(allcov[:, d].astype(np.float32))
                  for d in range(allcov.shape[1])]
        medians = np.array([q[1] for q in quarts])
        pseudo_vars = np.array([q[2] - q[0] for q in quarts]) ** 2
    else:
        medians = pseudo_vars = None

    log_trans = log_transition(n_states)
    log_init = np.log(np.full(n_states, 1.0 / n_states, np.float32))
    out: dict[str, list[int]] = {}
    for name, cov in coverage_by_contig.items():
        T = cov.shape[0]
        if T <= min_size:
            out[name] = [0]
            continue
        tables, _, clamped = build_emission_tables(
            cov, n_states, medians, pseudo_vars)
        x = torch.as_tensor(clamped.astype(np.float32), device=dev)[None]
        mask = torch.ones((1, T), dtype=torch.bool, device=dev)
        log_em = emission_log_probs(x, tables, mask,
                                    use_all_states=per_sample)
        path = viterbi_decode_chunked(log_em, mask, log_trans, log_init,
                                      chunk=chunk, lengths=[T]
                                      ).cpu().numpy()[0]
        out[name] = breakpoints_from_path(path)
    return out
