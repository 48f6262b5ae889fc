"""Joint pedigree copy-number caller (CanvasPedigreeCaller, SmallPedigree-WGS).

Reference semantics:
  * per-sample NB lookup models (CopyNumberModelFactory.cs:19-76): coverage
    tables with mean = haploidMean * CN (CN0 -> 0.1x), variance =
    meanCoverage * 2.5, clumping parameter floored at 6 (coverage) / 2
    (alleles) (DistributionUtilities.cs:52-72); per-haplotype allele-count
    tables and total-allele-depth tables;
  * single-sample CN likelihoods from the truncated median bin coverage
    clamped at 3x mean (CopyNumberLikelihoodCalculator.cs:22-66);
  * pedigree joint likelihood over (parent1 CN x parent2 CN x offspring
    phased genotypes) with Poisson(cn/2) transition probabilities
    (VariantCaller.GetPedigreeCopyNumbers :319-380, PedigreeInfo:108-122);
    parents keep only their top-3 CN states when there are >=2 offspring;
    per total-CN configuration only the best phased assignment counts
    (JointLikelihood.AddJointLikelihood);
  * q-score = -10log10(1 - L(best)/Z) from single-sample likelihoods
    (VariantCaller.cs:60-67), de novo quality from conditional marginal
    gain/loss likelihoods x2 (CanvasPedigreeCaller.cs:467-483), gated by
    REF/shared-CNV/sibling/quality checks (VariantCaller.cs:79-105);
  * MCC by phased-genotype likelihood with Mendelian consistency
    (VariantCaller.AssignMccWithPedigreeInfo :186-283).

All per-segment quantities vectorize across segments; the joint contraction
enumerates the (<=5 x <=5 x <=500) combo table once and gathers per-segment
likelihoods — the reference's per-segment Parallel.ForEach becomes one
array pass.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from itertools import product as _product

import numpy as np
import torch
from scipy import stats as sps
from scipy.special import gammaln, xlogy

from canvas_tpu_torch.config import resolve_device
from canvas_tpu_torch.models.segment_model import Segment
from canvas_tpu_torch.ops import stats

MAX_COPY_NUMBER = 5            # PedigreeCallerParameters.json
MAX_NUM_OFFSPRING_GENOTYPES = 500
MAX_QSCORE = 100.0
DENOVO_QUALITY_THRESHOLD = 20
NUMBER_OF_TRIMMED_BINS = 5
MIN_ALLELE_COUNTS_THRESHOLD = 4
MIN_ALLELE_NUMBER_IN_SEGMENT = 10
MINIMUM_CALL_SIZE = 2000
DQ_SCALE = 2.0                 # VariantCaller.cs:99
Q60 = 0.000001


def negative_binomial_table(mean: float, variance: float, max_value: int,
                            adjust_clumping: bool = False) -> np.ndarray:
    """DistributionUtilities.NegativeBinomialWrapper with the clumping
    floor (6 when adjusted, else 2)."""
    # IEEE semantics like the reference's C# doubles: zero mean/variance
    # gives r = inf and an (all-zero beyond x=0) degenerate table, not a crash
    with np.errstate(divide="ignore", invalid="ignore"):
        r = float(np.float64(max(mean, 0.1)) ** 2
                  / np.float64(max(variance, mean * 1.2) - mean))
    r = max(6.0 if adjust_clumping else 2.0, r)
    if not np.isfinite(r):
        r = 1e12  # effectively Poisson; yields the same 0/1 tables
    x = np.arange(max_value, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        logp = (-r * np.log1p(mean / r) + xlogy(x, mean) - x * np.log(mean + r)
                + gammaln(r + x) - gammaln(x + 1.0) - gammaln(r))
        dens = np.exp(logp)
    return np.where(np.isfinite(dens), dens, 0.0)


# ---------------------------------------------------------------------------
# Sample metrics + copy-number model
# ---------------------------------------------------------------------------

@dataclass
class SampleStats:
    """SampleMetrics.GetSampleInfo (SampleMetrics.cs:36-49)."""

    mean_coverage: float
    mean_maf_coverage: float
    variance: float
    maf_variance: float
    max_coverage: int
    ploidy_fn: object = None   # callable(segment) -> reference CN

    def get_ploidy(self, segment: Segment) -> int:
        if self.ploidy_fn is None:
            return 2
        return int(self.ploidy_fn(segment))

    @classmethod
    def from_segments(cls, segments: list[Segment],
                      ploidy_fn=None) -> "SampleStats":
        allele_cov = np.concatenate([
            s.baf_total_coverage for s in segments]) if segments else np.zeros(0)
        mean_maf_cov = stats.median_int(allele_cov) if len(allele_cov) else 0
        trunc_medians = np.array([
            s.truncated_median_count(NUMBER_OF_TRIMMED_BINS) for s in segments])
        variance = stats.variance(trunc_medians) if len(trunc_medians) > 1 else 0.0
        per_seg_maf_means = [s.baf_total_coverage.mean() for s in segments
                             if len(s.baf_total_coverage) > 0]
        maf_variance = stats.variance(per_seg_maf_means) \
            if len(per_seg_maf_means) > 1 else 0.0
        all_counts = np.concatenate([s.bin_counts for s in segments])
        mean_cov = stats.median(all_counts)
        max_cov = int(np.int16(int(trunc_medians.max()))) + 10
        return cls(mean_cov, float(mean_maf_cov), variance, maf_variance,
                   max_cov, ploidy_fn)


class CopyNumberModel:
    """HaplotypeCopyNumberModel + its factory."""

    def __init__(self, num_states: int, max_coverage: int,
                 mean_coverage: float, diploid_allele_mean: float):
        haploid_allele = diploid_allele_mean / 2.0
        haploid_mean = mean_coverage / 2.0
        maf_variance = diploid_allele_mean * 2.5
        variance = mean_coverage * 2.5
        self.num_states = num_states
        self.cn_table = np.stack([
            negative_binomial_table(
                haploid_mean * (0.1 if cn == 0 else cn), variance,
                max_coverage, adjust_clumping=True)
            for cn in range(num_states)])                       # [S, maxCov]
        self.allele_table = np.stack([
            negative_binomial_table(
                haploid_allele * max(gt, 0.1), maf_variance, max_coverage)
            for gt in range(num_states)])                       # [S, maxCov]
        self.coverage_ceiling = int(diploid_allele_mean * 3)
        self.max_total_allele = 2 * max_coverage
        self.total_allele_table = np.stack([
            negative_binomial_table(
                haploid_allele * gt, maf_variance, self.max_total_allele)
            for gt in range(2 * num_states)])                   # [2S, 2*maxCov]
        n = 2 * self.coverage_ceiling + 1
        self.log_factorial = np.concatenate(
            [[0.0, 0.0], np.cumsum(np.log(np.arange(2, n + 1)))])

    def coverage_bound(self) -> int:
        return self.max_total_allele // 2

    def total_cn_likelihood(self, coverage: float, cn: int) -> float:
        return float(self.cn_table[cn][int(np.rint(coverage))])

    def genotype_log_likelihood(self, counts_a: np.ndarray,
                                counts_b: np.ndarray,
                                cn_a: int, cn_b: int) -> float:
        """HaplotypeCopyNumberModel.GetGenotypeLogLikelihood (:50-110),
        vectorized over the segment's allele sites."""
        if len(counts_a) == 0:
            return 0.0
        ceil = self.coverage_ceiling
        row = np.minimum(counts_a, ceil - 1).astype(np.int64)
        col = np.minimum(counts_b, ceil - 1).astype(np.int64)
        n_nonzero = (cn_a > 0) + (cn_b > 0)
        lik = np.zeros(len(row))
        if n_nonzero == 2:
            pa, pb = self.allele_table[cn_a], self.allele_table[cn_b]
            lik += (1.0 / 3.0) * (pa[row] * pb[col] + pa[col] * pb[row])
        if n_nonzero > 0:
            log_err, log_noerr = math.log(0.01), math.log(0.99)
            prior_hom = 0.5 * (1.0 / 3.0) if n_nonzero == 2 else 1.0
            total = np.minimum(row + col, self.max_total_allele)
            # reference indexes [totalCN][totalReads] with maxTotalAlleleCoverage
            # table length; clamp to table size
            total = np.minimum(total, self.total_allele_table.shape[1] - 1)
            p_tot = self.total_allele_table[cn_a + cn_b][total]
            log_comb = (self.log_factorial[row + col]
                        - self.log_factorial[row] - self.log_factorial[col])
            p_err = (np.exp(log_comb + row * log_err + col * log_noerr)
                     + np.exp(log_comb + col * log_err + row * log_noerr))
            lik += prior_hom * p_tot * p_err
        if n_nonzero == 0:
            total = np.minimum(np.minimum(row + col, self.max_total_allele),
                               self.total_allele_table.shape[1] - 1)
            lik = self.total_allele_table[0][total]
        lik = np.maximum(lik, 1.0 / np.finfo(np.float64).max)
        return float(np.sum(np.log(lik)))

    def genotype_log_likelihoods_multi(
        self, counts_a: np.ndarray, counts_b: np.ndarray,
        genotypes: list[tuple[int, int]]) -> np.ndarray:
        """genotype_log_likelihood for MANY genotypes in one vectorized
        pass over a [n_genotypes, n_sites] grid — identical values, the
        per-call Python overhead paid once."""
        n_gt = len(genotypes)
        if len(counts_a) == 0:
            return np.zeros(n_gt)
        ceil = self.coverage_ceiling
        row = np.minimum(counts_a, ceil - 1).astype(np.int64)
        col = np.minimum(counts_b, ceil - 1).astype(np.int64)
        cn_a = np.array([g[0] for g in genotypes])
        cn_b = np.array([g[1] for g in genotypes])
        nz = (cn_a > 0).astype(np.int64) + (cn_b > 0).astype(np.int64)

        lik = np.zeros((n_gt, len(row)))
        # het term (both haplotypes present)
        pa = self.allele_table[cn_a]                       # [G, V]
        pb = self.allele_table[cn_b]
        het = (1.0 / 3.0) * (pa[:, row] * pb[:, col] + pa[:, col] * pb[:, row])
        lik += np.where((nz == 2)[:, None], het, 0.0)
        # homozygous-supported term (any haplotype present)
        log_err, log_noerr = math.log(0.01), math.log(0.99)
        total = np.minimum(np.minimum(row + col, self.max_total_allele),
                           self.total_allele_table.shape[1] - 1)
        p_tot = self.total_allele_table[cn_a + cn_b][:, total]  # [G, S]
        log_comb = (self.log_factorial[row + col]
                    - self.log_factorial[row] - self.log_factorial[col])
        p_err = (np.exp(log_comb + row * log_err + col * log_noerr)
                 + np.exp(log_comb + col * log_err + row * log_noerr))
        prior_hom = np.where(nz == 2, 0.5 / 3.0, 1.0)
        lik += np.where((nz > 0)[:, None],
                        prior_hom[:, None] * p_tot * p_err[None], 0.0)
        # no haplotype present
        zero_tot = self.total_allele_table[0][total]
        lik = np.where((nz == 0)[:, None], zero_tot[None], lik)
        lik = np.maximum(lik, 1.0 / np.finfo(np.float64).max)
        return np.sum(np.log(lik), axis=1)


def truncated_allele_counts(seg: Segment) -> tuple[np.ndarray, np.ndarray]:
    """Balleles.GetTruncatedAlleleCounts (CanvasSegment.cs:101-108):
    with >=10 sites, drop the first 3 and last 6-3 (in position order)."""
    ca, cb = seg.baf_count_a, seg.baf_count_b
    n = len(ca)
    if n >= 10:
        lo = 10 // 3              # 3
        take = n - int(10 / 1.5)  # n - 6
        return ca[lo:lo + take], cb[lo:lo + take]
    return ca, cb


def phased_genotypes(max_cn: int) -> list[tuple[int, int]]:
    """All (A, B) with A+B < max_cn (GeneratePhasedGenotype)."""
    return [(gt, cn - gt) for cn in range(max_cn) for gt in range(cn + 1)]


def transition_matrix(max_cn: int = MAX_COPY_NUMBER) -> np.ndarray:
    """Poisson(cn/2) pmf rows; row 0 is a point mass at 0
    (PedigreeInfo.GetTransitionMatrix)."""
    t = np.zeros((max_cn, max_cn))
    t[0, 0] = 1.0
    for cn in range(1, max_cn):
        t[cn] = sps.poisson.pmf(np.arange(max_cn), max(cn / 2.0, 0.1))
    return t


# ---------------------------------------------------------------------------
# Per-segment sample maps
# ---------------------------------------------------------------------------

@dataclass
class PedigreeSegment:
    """One genomic span across all samples (position-aligned)."""
    segments: dict[str, Segment]             # sample name -> Segment


def single_sample_likelihoods(
    seg: Segment, stats_: SampleStats, model: CopyNumberModel,
    max_cn: int = MAX_COPY_NUMBER) -> np.ndarray:
    """CopyNumberLikelihoodCalculator.GetCopyNumbersLikelihoods for one
    sample/segment: [max_cn] linear likelihoods."""
    cvg = min(seg.truncated_median_count(NUMBER_OF_TRIMMED_BINS),
              stats_.mean_coverage * 3.0)
    out = np.empty(max_cn)
    for cn in range(max_cn):
        v = model.total_cn_likelihood(cvg, cn)
        out[cn] = 0.0 if not np.isfinite(v) else v
    return out


# ---------------------------------------------------------------------------
# Pedigree joint likelihood
# ---------------------------------------------------------------------------

@dataclass
class JointResult:
    best: dict[str, int]                 # sample -> total CN
    maximal_log_likelihood: float
    total_marginal: float
    # per-config marginal store: key -> max likelihood
    configs: dict[tuple, float] = field(default_factory=dict)


def _offspring_phased_combos(n_offspring: int, max_cn: int,
                             seed: int = 0) -> list[tuple[tuple[int, int], ...]]:
    gts = phased_genotypes(max_cn)
    combos = list(_product(gts, repeat=n_offspring))
    if len(combos) > MAX_NUM_OFFSPRING_GENOTYPES:
        rng = np.random.default_rng(seed)
        idx = rng.permutation(len(combos))[:MAX_NUM_OFFSPRING_GENOTYPES]
        combos = [combos[i] for i in sorted(idx)]
    return combos


def pedigree_joint_likelihood(
    parent_liks: list[np.ndarray],       # 2 x [max_cn]
    child_liks: list[np.ndarray],        # C x [max_cn]
    trans: np.ndarray,                   # [max_cn, max_cn]
    max_cn: int = MAX_COPY_NUMBER,
    parents_top_k: int | None = None,
) -> JointResult:
    """GetPedigreeCopyNumbers for one segment (VariantCaller.cs:319-380)."""
    n_children = len(child_liks)
    if parents_top_k is None:
        parents_top_k = 3 if n_children >= 2 else max_cn
    child_top_k = 3 if n_children >= 2 else max_cn

    def top_states(lik, k):
        order = np.argsort(-lik, kind="stable")[:k]
        return set(int(i) for i in order)

    p1_states = top_states(parent_liks[0], parents_top_k)
    p2_states = top_states(parent_liks[1], parents_top_k)
    child_states = [top_states(cl, child_top_k) for cl in child_liks]

    combos = _offspring_phased_combos(n_children, max_cn)
    result = JointResult({}, -np.inf, 0.0)
    best_key = None
    for p1 in sorted(p1_states):
        for p2 in sorted(p2_states):
            base = parent_liks[0][p1] * parent_liks[1][p2]
            for geno in combos:
                totals = [min(a + b, max_cn - 1) for a, b in geno]
                if any(t not in child_states[c] for c, t in enumerate(totals)):
                    continue
                lik = base
                for c, (a, b) in enumerate(geno):
                    lik *= trans[p1][a] * trans[p2][b] * child_liks[c][totals[c]]
                if not np.isfinite(lik):
                    lik = 0.0
                key = (p1, p2) + tuple(totals)
                prev = result.configs.get(key)
                if prev is None:
                    result.configs[key] = lik
                    result.total_marginal += lik
                elif lik > prev:
                    result.total_marginal += lik - prev
                    result.configs[key] = lik
                ll = np.log(lik) if lik > 0 else -np.inf
                if ll > result.maximal_log_likelihood:
                    result.maximal_log_likelihood = ll
                    best_key = key
    if best_key is None:
        raise RuntimeError("Maximal likelihood was not found")
    result.best = {"parent1": best_key[0], "parent2": best_key[1],
                   **{f"child{c}": best_key[2 + c]
                      for c in range(n_children)}}
    return result


def _topk_mask_np(lik, k):
    order = np.argsort(-lik, axis=-1, kind="stable")
    rank = np.argsort(order, axis=-1, kind="stable")
    return rank < k


def joint_keyed_likelihoods_np(pl, cl, trans, A, Bv, totals, key_id, J,
                               parents_top_k, child_top_k):
    """The [G, S, S, J] keyed joint likelihoods and their presence mask in
    float64 numpy (bit-faithful to the host scalar loop)."""
    G, C = cl.shape[0], cl.shape[1]
    S = trans.shape[0]
    p1, p2 = pl[:, 0], pl[:, 1]
    p1_mask = _topk_mask_np(p1, parents_top_k)
    p2_mask = _topk_mask_np(p2, parents_top_k)
    c_mask = _topk_mask_np(cl, child_top_k)
    t1 = np.prod(trans[:, A], axis=-1)
    t2 = np.prod(trans[:, Bv], axis=-1)
    c_idx = np.broadcast_to(np.arange(C)[None, :], totals.shape)
    gathered = cl[:, c_idx, totals]
    child_prod = np.prod(gathered, axis=-1)
    ok = np.all(c_mask[:, c_idx, totals], axis=-1)
    lik = (p1[:, :, None, None] * p2[:, None, :, None]
           * t1[None, :, None, :] * t2[None, None, :, :]
           * child_prod[:, None, None, :])
    valid = (p1_mask[:, :, None, None] & p2_mask[:, None, :, None]
             & ok[:, None, None, :])
    lik = np.where(valid, lik, 0.0)
    keyed = np.zeros((G, S, S, J))
    present = np.zeros((G, S, S, J), bool)
    for j in range(J):
        keyed[..., j] = lik[..., key_id == j].max(axis=-1)
        present[..., j] = valid[..., key_id == j].any(axis=-1)
    return keyed, present


def _topk_mask_torch(lik, k):
    order = torch.argsort(-lik, dim=-1, stable=True)
    rank = torch.argsort(order, dim=-1, stable=True)
    return rank < k


def _prod_last(x):
    """Product over the last axis as explicit left-to-right multiplies,
    the order of numpy's multiply reduction."""
    out = x[..., 0]
    for c in range(1, x.shape[-1]):
        out = out * x[..., c]
    return out


def joint_keyed_likelihoods_torch(pl, cl, trans, A, Bv, totals, key_id, J,
                                  parents_top_k, child_top_k):
    """joint_keyed_likelihoods_np in torch float64 on pl's device: the same
    multiplies in the same order, so the results are equal bit for bit.
    pl, cl: float64 tensors; the rest are host arrays."""
    dev = pl.device
    G, C = cl.shape[0], cl.shape[1]
    S = trans.shape[0]
    tr = torch.as_tensor(np.asarray(trans, np.float64), device=dev)
    A_t = torch.as_tensor(A, device=dev)
    B_t = torch.as_tensor(Bv, device=dev)
    tot = torch.as_tensor(totals, device=dev)
    p1, p2 = pl[:, 0], pl[:, 1]
    p1_mask = _topk_mask_torch(p1, parents_top_k)
    p2_mask = _topk_mask_torch(p2, parents_top_k)
    c_mask = _topk_mask_torch(cl, child_top_k)
    t1 = _prod_last(tr[:, A_t])                                 # [S, K]
    t2 = _prod_last(tr[:, B_t])
    c_idx = torch.arange(C, device=dev)[None, :].expand(tot.shape)
    child_prod = _prod_last(cl[:, c_idx, tot])                  # [G, K]
    ok = c_mask[:, c_idx, tot].all(dim=-1)                      # [G, K]
    lik = (p1[:, :, None, None] * p2[:, None, :, None]
           * t1[None, :, None, :] * t2[None, None, :, :]
           * child_prod[:, None, None, :])                      # [G,S,S,K]
    valid = (p1_mask[:, :, None, None] & p2_mask[:, None, :, None]
             & ok[:, None, None, :])
    lik = torch.where(valid, lik, torch.zeros((), dtype=lik.dtype,
                                              device=dev))
    keyed = torch.zeros((G, S, S, J), dtype=torch.float64, device=dev)
    present = torch.zeros((G, S, S, J), dtype=torch.bool, device=dev)
    for j in range(J):
        sel = torch.as_tensor(np.flatnonzero(key_id == j), device=dev)
        keyed[..., j] = lik[..., sel].amax(dim=-1)
        present[..., j] = valid[..., sel].any(dim=-1)
    return keyed, present


def pedigree_joint_likelihood_batched(
    parent_liks: np.ndarray,             # [G, 2, max_cn]
    child_liks: np.ndarray,              # [G, C, max_cn]
    trans: np.ndarray,                   # [max_cn, max_cn]
    max_cn: int = MAX_COPY_NUMBER,
    parents_top_k: int | None = None,
    device: str | torch.device = "cuda",
) -> list[JointResult]:
    """GetPedigreeCopyNumbers over ALL segments at once (SURVEY §7(5)): the
    (parent1CN x parent2CN x offspring-genotype) contraction runs as one
    [G, S, S, K] tensor instead of the reference's per-segment loop
    (VariantCaller.cs:319-380).  Returns one JointResult per segment with
    identical best/marginal/config semantics to pedigree_joint_likelihood
    (validated in tests).  On a CUDA device the contraction runs in torch
    float64 there; on the CPU in float64 numpy — bit-equal either way.
    Asking for a missing card raises."""
    dev = resolve_device(device)
    G = parent_liks.shape[0]
    C = child_liks.shape[1]
    if parents_top_k is None:
        parents_top_k = 3 if C >= 2 else max_cn
    child_top_k = 3 if C >= 2 else max_cn

    combos = _offspring_phased_combos(C, max_cn)
    K = len(combos)
    A = np.array([[g[0] for g in combo] for combo in combos])   # [K, C]
    Bv = np.array([[g[1] for g in combo] for combo in combos])  # [K, C]
    totals = np.minimum(A + Bv, max_cn - 1)                     # [K, C]
    # key = unique totals row, id in order of first occurrence (matches the
    # host loop's config-dict insertion order)
    key_of: dict[tuple, int] = {}
    key_id = np.empty(K, np.int64)
    for k in range(K):
        t = tuple(int(x) for x in totals[k])
        key_id[k] = key_of.setdefault(t, len(key_of))
    J = len(key_of)
    key_totals = np.empty((J, C), np.int64)
    for t, j in key_of.items():
        key_totals[j] = t

    spec = (trans, A, Bv, totals, key_id, J, parents_top_k, child_top_k)
    if dev.type == "cpu":
        keyed, present = joint_keyed_likelihoods_np(
            np.asarray(parent_liks, np.float64),
            np.asarray(child_liks, np.float64), *spec)
    else:
        keyed, present = joint_keyed_likelihoods_torch(
            torch.as_tensor(np.asarray(parent_liks, np.float64), device=dev),
            torch.as_tensor(np.asarray(child_liks, np.float64), device=dev),
            *spec)
        keyed, present = keyed.cpu().numpy(), present.cpu().numpy()

    results: list[JointResult] = []
    for g in range(G):
        kg = keyed[g]                                       # [S, S, J]
        total = float(kg.sum())
        flat = kg.reshape(-1)
        best_idx = int(np.argmax(flat))
        max_lik = float(flat[best_idx])
        if max_lik <= 0:
            raise RuntimeError("Maximal likelihood was not found")
        p1b, p2b, jb = np.unravel_index(best_idx, kg.shape)
        res = JointResult(
            best={"parent1": int(p1b), "parent2": int(p2b),
                  **{f"child{c}": int(key_totals[jb, c]) for c in range(C)}},
            maximal_log_likelihood=float(np.log(max_lik)),
            total_marginal=total)
        nz = np.argwhere(present[g])
        for p1i, p2i, j in nz:
            key = (int(p1i), int(p2i)) + tuple(int(x) for x in key_totals[j])
            res.configs[key] = float(kg[p1i, p2i, j])
        results.append(res)
    return results


def single_sample_qscore(liks: np.ndarray, cn: int,
                         max_qscore: float = MAX_QSCORE) -> float:
    """VariantCaller.GetSingleSampleQualityScore (:60-67)."""
    z = float(np.sum(liks))
    with np.errstate(divide="ignore", invalid="ignore"):
        q = -10.0 * np.log10((z - liks[cn]) / z)
    if not np.isfinite(q) or q > max_qscore:
        q = max_qscore
    return float(q)


def denovo_quality(
    result: JointResult,
    proband_idx: int,
    proband_cn: int,
    proband_ploidy: int,
    parent1_ploidy: int,
    parent2_ploidy: int,
    max_qscore: float = MAX_QSCORE,
) -> float:
    """GetConditionalDeNovoQualityScore (CanvasPedigreeCaller.cs:467-483) with
    the x2 Manta adjustment (VariantCaller.cs:99)."""
    gain = loss = 0.0
    for key, lik in result.configs.items():
        p1, p2 = key[0], key[1]
        pro = key[2 + proband_idx]
        if pro > proband_ploidy and p1 <= parent1_ploidy and p2 <= parent2_ploidy:
            gain += lik
        if pro < proband_ploidy and p1 >= parent1_ploidy and p2 >= parent2_ploidy:
            loss += lik
    if proband_cn > proband_ploidy:
        p = 1 - gain / (result.total_marginal - loss)
    else:
        p = 1 - loss / (result.total_marginal - gain)
    dq = -10.0 * np.log10(max(p, Q60)) * DQ_SCALE
    if not np.isfinite(dq) or dq > max_qscore:
        dq = max_qscore
    return float(dq)


def contains_shared_allele(allele_cn: int, genotype: tuple[int, int]) -> bool:
    """PhasedGenotype.ContainsSharedAlleleA/B (PhasedGenotype.cs:21-29):
    an allele copy number is shared when it equals either of the other
    genotype's allele copy numbers."""
    return allele_cn == genotype[0] or allele_cn == genotype[1]


def genotype_equals(g1: tuple[int, ...], g2: tuple[int, ...]) -> bool:
    """Genotype.Equals (Genotype.cs:47-53): two phased genotypes compare
    allele-wise ((2,1) != (1,2)); when either side carries only a total
    copy number, equality is total-CN equality — so total 3 == phased
    (2,1).  Genotype keys here are (total,) or (cnA, cnB) tuples."""
    if len(g1) == 2 and len(g2) == 2:
        return g1 == g2
    return sum(g1) == sum(g2)


def is_shared_cnv_phased(proband_gt: tuple[int, int],
                         parent1_gt: tuple[int, int],
                         parent2_gt: tuple[int, int]) -> bool:
    """IsSharedCnv phased-genotype version (CanvasPedigreeCaller.cs:485-500):
    the proband's A allele must be shared with one parent and its B allele
    with the other (either pairing)."""
    return ((contains_shared_allele(proband_gt[0], parent1_gt)
             and contains_shared_allele(proband_gt[1], parent2_gt))
            or (contains_shared_allele(proband_gt[0], parent2_gt)
                and contains_shared_allele(proband_gt[1], parent1_gt)))


def is_shared_cnv(cns: dict, ploidies: dict, parent_keys: list[str],
                  proband_key: str, max_cn: int = MAX_COPY_NUMBER) -> bool:
    """IsSharedCnv total-CN version (CanvasPedigreeCaller.cs:510-527)."""
    p1 = min(cns[parent_keys[0]], max_cn - 1)
    p2 = min(cns[parent_keys[1]], max_cn - 1)
    pro = min(cns[proband_key], max_cn - 1)
    pl1, pl2, plp = (ploidies[parent_keys[0]], ploidies[parent_keys[1]],
                     ploidies[proband_key])
    denovo_gain = p1 <= pl1 and p2 <= pl2 and pro > plp
    denovo_loss = p1 >= pl1 and p2 >= pl2 and pro < plp
    return not (denovo_gain or denovo_loss)


# ---------------------------------------------------------------------------
# Major chromosome count (MCC) assignment
# ---------------------------------------------------------------------------

def use_allele_counts(segs: dict[str, Segment],
                      min_counts: int = MIN_ALLELE_COUNTS_THRESHOLD,
                      min_number: int = MIN_ALLELE_NUMBER_IN_SEGMENT) -> bool:
    """UseAlleleCountsInformation (CanvasPedigreeCaller.cs:447-457)."""
    for seg in segs.values():
        n = int(np.count_nonzero(seg.baf_total_coverage >= min_counts))
        if n < min_number:
            return False
    return True


def _genotypes_for_cn(cn: int) -> list[tuple[int, int]]:
    return [(gt, cn - gt) for gt in range(cn + 1)]


def gt_log_likelihood_score(
    seg: Segment, model: CopyNumberModel, genotypes: list[tuple[int, int]],
    selected: int | None) -> tuple[float, int | None]:
    """GetGtLogLikelihoodScore (VariantCaller.cs:285-306): phred-scaled
    confidence of the best (upper-triangle) genotype."""
    ca, cb = truncated_allele_counts(seg)
    upper = [k for k, (a, b) in enumerate(genotypes) if a >= b]
    lls = np.full(len(genotypes), -np.inf)
    lls[upper] = model.genotype_log_likelihoods_multi(
        ca, cb, [genotypes[k] for k in upper])
    max_ll = lls.max()
    if selected is None:
        selected = int(np.argmax(lls))
    z = float(np.sum(np.exp(lls - max_ll)))
    with np.errstate(divide="ignore", invalid="ignore"):
        gq = -10.0 * np.log10((z - 1) / z)
    if not np.isfinite(gq) or gq > 60:
        gq = 60.0
    if np.isnan(gq):
        gq = 0.0
    return float(gq), selected


def _is_consistent(parent: tuple[int, int], child: tuple[int, int]) -> bool:
    """IsGtPedigreeConsistent (VariantCaller.cs:255-261)."""
    pa, pb = parent
    ca, cb = child
    return pa == ca or pb == ca or pa == cb or pb == cb


def _assign_mcc(seg: Segment, model: CopyNumberModel,
                gt: tuple[int, int], cn: int) -> None:
    """AssignMcc (VariantCaller.cs:263-283)."""
    if cn > 2:
        seg.major_chromosome_count = max(gt)
        sel = _genotypes_for_cn(cn).index(gt)
        score, _ = gt_log_likelihood_score(seg, model, _genotypes_for_cn(cn), sel)
        seg.mcc_score = score
    else:
        seg.major_chromosome_count = None if cn == 2 else cn
        seg.mcc_score = None


def assign_mcc_with_pedigree(
    segs: dict[str, Segment], models: dict[str, CopyNumberModel],
    parents: list[str], offspring: list[str]) -> None:
    """AssignMccWithPedigreeInfo (VariantCaller.cs:186-232)."""
    p1, p2 = parents
    cn1, cn2 = segs[p1].copy_number, segs[p2].copy_number
    best_ll = -np.inf
    trunc = {n: truncated_allele_counts(segs[n]) for n in segs}

    # each sample's per-genotype likelihood is constant across the (g1, g2)
    # outer loops — compute each ONCE, batched over its genotype list (the
    # reference recomputes them inside the nested loops,
    # VariantCaller.cs:198-216; values are identical)
    _cache = {
        name: dict(zip(
            _genotypes_for_cn(segs[name].copy_number),
            models[name].genotype_log_likelihoods_multi(
                *trunc[name], _genotypes_for_cn(segs[name].copy_number))))
        for name in segs}

    def gt_ll(name, gt):
        return _cache[name][gt]

    for g1 in _genotypes_for_cn(cn1):
        for g2 in _genotypes_for_cn(cn2):
            child_best: list[tuple[int, int] | None] = []
            total = 0.0
            for c in offspring:
                child_cn = segs[c].copy_number
                inherited = segs[c].dq_score is None
                b_ll, b_gt = -np.inf, None
                for gc in _genotypes_for_cn(child_cn):
                    if not (inherited and _is_consistent(g1, gc)
                            and _is_consistent(g2, gc)):
                        continue
                    ll = gt_ll(c, gc)
                    if ll > b_ll:
                        b_ll, b_gt = ll, gc
                child_best.append(b_gt)
                total += b_ll
            total += gt_ll(p1, g1) + gt_ll(p2, g2)
            if not np.isfinite(total):
                total = -np.inf
            if total > best_ll:
                best_ll = total
                _assign_mcc(segs[p1], models[p1], g1, cn1)
                _assign_mcc(segs[p2], models[p2], g2, cn2)
                for c, bg in zip(offspring, child_best):
                    if bg is None:
                        continue
                    _assign_mcc(segs[c], models[c], bg, segs[c].copy_number)


def assign_mcc_no_pedigree(
    segs: dict[str, Segment], models: dict[str, CopyNumberModel]) -> None:
    """AssignMccNoPedigreeInfo (VariantCaller.cs:153-181)."""
    for n, seg in segs.items():
        cn = seg.copy_number
        if cn <= 2:
            seg.major_chromosome_count = None if cn == 2 else cn
            continue
        genotypes = _genotypes_for_cn(cn)
        score, sel = gt_log_likelihood_score(seg, models[n], genotypes, None)
        if sel is not None:
            seg.major_chromosome_count = max(genotypes[sel])
            seg.mcc_score = score


# ---------------------------------------------------------------------------
# Full trio/pedigree calling over aligned segment lists
# ---------------------------------------------------------------------------

def call_pedigree(
    segments_by_sample: dict[str, list[Segment]],
    sample_types: dict[str, str],         # name -> Father/Mother/Proband/Sibling/Other
    ploidy_fns: dict[str, object] | None = None,
    quality_threshold: int = 10,
    max_cn: int = MAX_COPY_NUMBER,
    device: str | torch.device = "cuda",
) -> dict[str, list[Segment]]:
    """CallVariants core (CanvasPedigreeCaller.cs:74-158 + VariantCaller).

    Segment lists must be position-aligned across samples.  Assigns
    CopyNumber, QScore, Filter, and DQ in place; returns the input map.
    The pedigree joint likelihood runs on `device`; asking for a missing
    card raises.
    """
    device = resolve_device(device)
    ploidy_fns = ploidy_fns or {}
    names = list(segments_by_sample.keys())
    parents = [n for n in names if sample_types[n] in ("Father", "Mother")]
    offspring = [n for n in names if sample_types[n] in ("Proband", "Sibling")]
    full_pedigree = (
        sum(1 for n in names if sample_types[n] == "Father") == 1
        and sum(1 for n in names if sample_types[n] == "Mother") == 1
        and sum(1 for n in names if sample_types[n] == "Proband") == 1)
    others = [n for n in names if sample_types[n] == "Other"] \
        if full_pedigree else names
    if not full_pedigree:
        parents, offspring = [], []

    stats_by_sample = {
        n: SampleStats.from_segments(segments_by_sample[n],
                                     ploidy_fns.get(n))
        for n in names}
    models = {
        n: CopyNumberModel(max_cn, stats_by_sample[n].max_coverage,
                           stats_by_sample[n].mean_coverage,
                           stats_by_sample[n].mean_maf_coverage)
        for n in names}
    trans = transition_matrix(max_cn)
    n_segments = len(next(iter(segments_by_sample.values())))

    # per-sample likelihoods for every segment up front (vectorizable table
    # lookups), then ONE batched device contraction over all segments for
    # the pedigree joint likelihood (VariantCaller.cs:319-380 per-segment
    # loop -> [G, S, S, K] tensor; SURVEY §7(5))
    all_liks = {
        n: np.stack([single_sample_likelihoods(
            segments_by_sample[n][i], stats_by_sample[n], models[n], max_cn)
            for i in range(n_segments)])
        for n in names}
    joint_results: list[JointResult] | None = None
    if full_pedigree and n_segments:
        joint_results = pedigree_joint_likelihood_batched(
            np.stack([all_liks[parents[0]], all_liks[parents[1]]], axis=1),
            np.stack([all_liks[c] for c in offspring], axis=1),
            trans, max_cn, device=device)

    for i in range(n_segments):
        segs = {n: segments_by_sample[n][i] for n in names}
        liks = {n: all_liks[n][i] for n in names}

        if full_pedigree:
            result = joint_results[i]
            cns = {parents[0]: result.best["parent1"],
                   parents[1]: result.best["parent2"]}
            for c_idx, c in enumerate(offspring):
                cns[c] = result.best[f"child{c_idx}"]
        else:
            result = None
            cns = {}
        for n in others:
            cns[n] = int(np.argmax(liks[n]))

        for n in names:
            segs[n].copy_number = cns[n]
            segs[n].qscore = single_sample_qscore(liks[n], cns[n])
            if segs[n].qscore < quality_threshold:
                segs[n].filter_tags = [f"q{quality_threshold}"]

        if full_pedigree and result is not None:
            ploidies = {n: stats_by_sample[n].get_ploidy(segs[n])
                        for n in names}
            for c_idx, proband in enumerate(offspring):
                if cns[proband] == ploidies[proband]:
                    continue
                if is_shared_cnv(cns, ploidies, parents, proband, max_cn):
                    continue
                sibs = [o for o in offspring if o != proband]
                if not all(cns[s] == ploidies[s] for s in sibs):
                    continue
                if any(segs[n].qscore < quality_threshold
                       for n in parents + [proband]):
                    continue
                segs[proband].dq_score = denovo_quality(
                    result, c_idx, cns[proband], ploidies[proband],
                    ploidies[parents[0]], ploidies[parents[1]])

        # MCC assignment (VariantCaller.CallVariant :141-146)
        if use_allele_counts(segs):
            if full_pedigree:
                assign_mcc_with_pedigree(
                    {n: segs[n] for n in parents + offspring}, models,
                    parents, offspring)
            if others:
                assign_mcc_no_pedigree({n: segs[n] for n in others}, models)
    return segments_by_sample


# ---------------------------------------------------------------------------
# HaplotypeVariantCaller — the alternative caller selected by the
# DefaultCaller parameter (HaplotypeVariantCaller.cs)
# ---------------------------------------------------------------------------

DENOVO_RATE = 1e-5             # PedigreeCallerParameters.json
_LOG_FLOOR = -1.7976931348623157e308   # double.MinValue floor (:95)


def _safe_log(x: float) -> float:
    return float(np.log(x)) if x > 0 else -np.inf


def haplotype_single_sample_log_likelihoods(
    seg: Segment, stats_: SampleStats, model: CopyNumberModel,
    n_balleles: int, use_alleles: bool,
    max_cn: int = MAX_COPY_NUMBER,
) -> dict[tuple[int, int] | tuple[int], float]:
    """Per-sample genotype log-likelihoods (HaplotypeVariantCaller.cs:28-113).

    With allele information: phased (A, B) keys, gt log-likelihood scaled by
    1/nBalleles joined with the log coverage likelihood of the total CN,
    after the REF-dominance fix that floors both LOH genotypes when REF
    (1,1) beats them (:60-64).  Without: total-CN keys, plain log coverage
    likelihood."""
    cov = single_sample_likelihoods(seg, stats_, model, max_cn)
    if not use_alleles:
        return {(cn,): _safe_log(cov[cn]) for cn in range(max_cn)}
    ll = {(a, b): model.genotype_log_likelihood(
        seg.baf_count_a, seg.baf_count_b, a, b)
        for (a, b) in phased_genotypes(max_cn)}
    if ll[(1, 1)] >= max(ll[(0, 2)], ll[(2, 0)]):
        finite = [v for v in ll.values() if v > -np.inf]
        floor = min(finite) if finite else -np.inf
        ll[(0, 2)] = ll[(2, 0)] = floor
    return {(a, b): v / max(1, n_balleles)
            + max(_LOG_FLOOR, _safe_log(cov[a + b]))
            for (a, b), v in ll.items()}


def _transmission_log_prob(p1_key, p2_key, child_key, trans,
                           denovo_rate: float = DENOVO_RATE) -> float:
    """EstimateTransmissionProbability (:190-206): with phased genotypes on
    both parents, 1.0 when the child shares an A-allele count with either
    parent AND a B-allele count with either parent, else the de novo rate;
    total-CN genotypes fall back to the Poisson transition product."""
    if len(p1_key) == 2 and len(p2_key) == 2 and len(child_key) == 2:
        ca, cb = child_key
        shared_a = ca in p1_key or ca in p2_key
        shared_b = cb in p1_key or cb in p2_key
        return 0.0 if (shared_a and shared_b) else float(np.log(denovo_rate))
    t1 = trans[sum(p1_key)][sum(child_key)]
    t2 = trans[sum(p2_key)][sum(child_key)]
    return _safe_log(t1 * t2)


def haplotype_pedigree_joint(
    parent_lls: list[dict], child_lls: list[dict], trans: np.ndarray,
    max_cn: int = MAX_COPY_NUMBER,
    denovo_rate: float = DENOVO_RATE,
) -> tuple[dict, JointResult]:
    """GetPedigreeCopyNumbers over genotype dictionaries (:118-185).

    Returns ({'parent1': key, 'parent2': key, 'childN': key}, JointResult)
    where the JointResult configs are keyed by total CN per sample so the
    de novo machinery (denovo_quality) applies unchanged."""
    n_children = len(child_lls)
    k = 3 if n_children >= 2 else max_cn

    def top(d):
        return dict(sorted(d.items(), key=lambda kv: -kv[1])[:k])

    p1 = top(parent_lls[0])
    p2 = top(parent_lls[1])
    kids = [top(c) for c in child_lls]
    kid_keys = [list(kd.keys()) for kd in kids]
    combos = list(_product(*kid_keys)) if n_children else [()]
    if len(combos) > MAX_NUM_OFFSPRING_GENOTYPES:
        rng = np.random.default_rng(0)
        idx = rng.permutation(len(combos))[:MAX_NUM_OFFSPRING_GENOTYPES]
        combos = [combos[i] for i in sorted(idx)]

    result = JointResult({}, -np.inf, 0.0)
    best = None
    for g1, l1 in p1.items():
        for g2, l2 in p2.items():
            for geno in combos:
                ll = l1 + l2
                for c, gc in enumerate(geno):
                    ll += kids[c][gc]
                    ll += _transmission_log_prob(g1, g2, gc, trans,
                                                 denovo_rate)
                if not np.isfinite(ll):
                    ll = -np.inf
                lik = float(np.exp(ll)) if np.isfinite(ll) else 0.0
                key = (min(sum(g1), max_cn - 1), min(sum(g2), max_cn - 1)) \
                    + tuple(min(sum(g), max_cn - 1) for g in geno)
                result.configs[key] = result.configs.get(key, 0.0) + lik
                result.total_marginal += lik
                if ll > result.maximal_log_likelihood:
                    result.maximal_log_likelihood = ll
                    best = {"parent1": g1, "parent2": g2,
                            **{f"child{c}": geno[c]
                               for c in range(n_children)}}
    if best is None:
        raise RuntimeError("Maximal likelihood was not found")
    return best, result


def haplotype_single_sample_qscore(lls: dict, selected, 
                                   max_qscore: float = MAX_QSCORE) -> float:
    """GetSingleSampleQualityScore over genotype log-likelihoods
    (:288-299): posterior mass of all genotypes sharing the selected
    total CN."""
    total = sum(selected)
    vals = np.array(list(lls.values()))
    m = vals.max()
    z = float(np.sum(np.exp(vals - m)))
    alt = float(sum(np.exp(v - m) for g, v in lls.items()
                    if sum(g) == total))
    with np.errstate(divide="ignore"):
        q = -10.0 * np.log10((z - alt) / z)
    if not np.isfinite(q) or q > max_qscore:
        q = max_qscore
    return float(q)


def call_pedigree_haplotype(
    segments_by_sample: dict[str, list[Segment]],
    sample_types: dict[str, str],
    ploidy_fns: dict[str, object] | None = None,
    quality_threshold: int = 10,
    max_cn: int = MAX_COPY_NUMBER,
) -> dict[str, list[Segment]]:
    """HaplotypeVariantCaller.CallVariant over all segments (:27-58)."""
    ploidy_fns = ploidy_fns or {}
    names = list(segments_by_sample.keys())
    parents = [n for n in names if sample_types[n] in ("Father", "Mother")]
    offspring = [n for n in names
                 if sample_types[n] in ("Proband", "Sibling")]
    full_pedigree = (
        sum(1 for n in names if sample_types[n] == "Father") == 1
        and sum(1 for n in names if sample_types[n] == "Mother") == 1
        and sum(1 for n in names if sample_types[n] == "Proband") == 1)
    others = [n for n in names if sample_types[n] == "Other"] \
        if full_pedigree else names
    if not full_pedigree:
        parents, offspring = [], []

    stats_by_sample = {
        n: SampleStats.from_segments(segments_by_sample[n],
                                     ploidy_fns.get(n)) for n in names}
    models = {
        n: CopyNumberModel(max_cn, stats_by_sample[n].max_coverage,
                           stats_by_sample[n].mean_coverage,
                           stats_by_sample[n].mean_maf_coverage)
        for n in names}
    trans = transition_matrix(max_cn)
    n_segments = len(next(iter(segments_by_sample.values())))

    for i in range(n_segments):
        segs = {n: segments_by_sample[n][i] for n in names}
        use_alleles = use_allele_counts(segs)
        n_balleles = len(segs[names[0]].baf_frequencies)
        lls = {n: haplotype_single_sample_log_likelihoods(
            segs[n], stats_by_sample[n], models[n], n_balleles,
            use_alleles, max_cn) for n in names}

        chosen: dict[str, tuple] = {}
        result = None
        if full_pedigree:
            best, result = haplotype_pedigree_joint(
                [lls[parents[0]], lls[parents[1]]],
                [lls[c] for c in offspring], trans, max_cn)
            chosen[parents[0]] = best["parent1"]
            chosen[parents[1]] = best["parent2"]
            for c_idx, c in enumerate(offspring):
                chosen[c] = best[f"child{c_idx}"]
        for n in others:
            chosen[n] = max(lls[n], key=lls[n].get)

        for n in names:
            g = chosen[n]
            segs[n].copy_number = min(sum(g), max_cn - 1)
            segs[n].qscore = haplotype_single_sample_qscore(lls[n], g)
            if len(g) == 2:
                segs[n].major_chromosome_count = max(g)
            if segs[n].qscore < quality_threshold:
                segs[n].filter_tags = [f"q{quality_threshold}"]

        if full_pedigree and result is not None:
            ploidies = {n: stats_by_sample[n].get_ploidy(segs[n])
                        for n in names}
            cns = {n: segs[n].copy_number for n in names}
            for c_idx, proband in enumerate(offspring):
                if cns[proband] == ploidies[proband]:
                    continue
                # HaplotypeVariantCaller.SetDenovoQualityScores (:243) routes
                # through the Genotype-map IsSharedCnv overload: a phased
                # proband genotype uses the parent shared-allele check
                # (CanvasPedigreeCaller.cs:485-500); total-CN keys fall back
                # to the ploidy-based version (:494).
                # Deliberate deviation: the reference gates only on the
                # proband (CanvasPedigreeCaller.cs:493) and would NRE on a
                # phased proband with an unphased parent; we require all
                # three phased before taking the phased path.  Genotypes
                # from haplotype_pedigree_joint are homogeneous in arity,
                # so the branch only differs on inputs the reference
                # cannot handle.
                phased = (len(chosen[proband]) == 2
                          and len(chosen[parents[0]]) == 2
                          and len(chosen[parents[1]]) == 2)
                shared = (
                    is_shared_cnv_phased(chosen[proband], chosen[parents[0]],
                                         chosen[parents[1]])
                    if phased
                    else is_shared_cnv(cns, ploidies, parents, proband,
                                       max_cn))
                if shared:
                    continue
                sibs = [o for o in offspring if o != proband]
                if not all(cns[s] == ploidies[s] for s in sibs):
                    continue
                if any(segs[n].qscore <= quality_threshold
                       for n in parents + [proband]):
                    continue
                segs[proband].dq_score = denovo_quality(
                    result, c_idx, cns[proband], ploidies[proband],
                    ploidies[parents[0]], ploidies[parents[1]])
    return segments_by_sample
