"""Chunked-Viterbi kernels B2 and B3, with their plain torch versions.

Lanes are chunks of sequences, laid out lane-last: emissions em f32
[chunk, S, L]; `base` int32 [L] is each lane's chunk-start time and
`length` int32 [L] its sequence length, so step k of a lane is live when
base + k < length (prefix masks) and base + k == 0 resets the scores to
log_init + e.

  chunk_matrices     (B2): per lane, the (max,+) product of the chunk's
                     step matrices, M[i,j] <- max_k(M[i,k] + lt[k,j]) + e[j];
                     f32 [S, S, L].  For a uniform model (equal diagonal
                     `self`, equal off-diagonal `off`, off < self: the
                     decode's) both versions take the TPU kernel's chain
                     max(M[i,j] + self, rowmax_i + off) + e[j], equal bit
                     for bit to the general one (fl(x + c) is monotone in
                     x) at 100 instead of 250 operations a lane-step
  forward_backtrack  (B3): per lane, the forward DP from the chunk-start
                     scores with first-max backpointers, then the backtrack
                     from all S assumed chunk-end states; int8 paths
                     [chunk, S, L] and prev_end [S, L].  The kernel keeps
                     the backpointers in shared memory, so chunk is at
                     most viterbi_max_chunk() on CUDA tensors
  chunk_scan         (K5): phase 2, the (max,+) prefix over each sequence's
                     chunk matrices, bracketed as canvas_tpu's
                     jax.lax.associative_scan brackets it (a tree): the
                     chunk-start scores f32 [S, L] that B3 takes (chunk 0
                     starts at 0, chunk c at the end scores of chunk
                     c - 1) and each sequence's best last end state,
                     int32 [B]
  chunk_chase        (K6): phase 4b, each chunk's end state: the suffix
                     composition of the later chunks' prev_end maps (B3's)
                     applied to the last chunk's best end state, by
                     pointer doubling; the int64 [L] selectors of the
                     decode's final gather

K5 and K6 port XLA work of canvas_tpu's decode (viterbi_pallas.py:282-290
and :314-324), not Pallas kernels; with them a decode on the card reads
nothing back to the host.

On CUDA tensors the wrappers launch csrc/viterbi.cu; on CPU tensors they
run the plain versions.  B2, B3 and K5 only add and take maxima in f32,
with every add bracketed as in the plain version (for K5, as in
canvas_tpu's associative scan), and K6 moves small integers, so the
outputs are equal bit for bit.  B2's bound at the
production decode shape is its bytes, 130.6 MB of live emissions and
outputs (0.0390 ms at 3.35 TB/s), for the uniform chain's 100 adds and
maxima a live lane-step take 0.0184 ms of f32 issue slots; the general
chain's 250 would take 0.0461 ms.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from canvas_tpu_torch.ops import cuda_lib

NEG_INF = -1e30
N_STATES = 5      # the kernels are compiled for S = 5

# launches of each kernel, counted by the wrappers
LAUNCHES = {"chunk_matrix": 0, "forward_backtrack": 0, "chunk_scan": 0,
            "chunk_chase": 0}
# B2's launches by the chain they ran
CHAINS = {"uniform": 0, "general": 0}

_F32P = ctypes.POINTER(ctypes.c_float)
_SIGNATURES = {
    "viterbi_chunk_matrices": [ctypes.c_void_p] * 4
    + [ctypes.c_int, ctypes.c_longlong, _F32P, _F32P, ctypes.c_int,
       ctypes.c_void_p],
    "viterbi_forward_backtrack": [ctypes.c_void_p] * 6
    + [ctypes.c_int, ctypes.c_longlong, _F32P, _F32P, ctypes.c_void_p],
    "viterbi_chunk_scan": [ctypes.c_void_p] * 4
    + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    "viterbi_scan_scratch_mats": [ctypes.c_int],
    "viterbi_chunk_chase": [ctypes.c_void_p] * 3
    + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    "viterbi_n_states": [],
    "viterbi_max_chunk": [],
}


def _model_args(log_trans, log_init):
    lt = np.ascontiguousarray(log_trans, dtype=np.float32).reshape(-1)
    li = np.ascontiguousarray(log_init, dtype=np.float32).reshape(-1)
    if lt.size != N_STATES * N_STATES or li.size != N_STATES:
        raise ValueError(f"the kernels take S={N_STATES} states")
    return (ctypes.c_float * lt.size)(*lt.tolist()), \
        (ctypes.c_float * li.size)(*li.tolist())


def uniform_transitions(log_trans) -> tuple[float, float] | None:
    """(self, off) of a uniform f32 transition matrix (equal diagonal,
    equal off-diagonal, off < self), else None: the test of
    canvas_tpu/ops/viterbi_pallas.py:_uniform_trans."""
    lt = np.asarray(log_trans, np.float32)
    S = lt.shape[0]
    if S < 2:
        return None
    self_p, off = lt[0, 0], lt[0, 1]
    if not off < self_p:
        return None
    want = np.where(np.eye(S, dtype=bool), self_p, off)
    if not np.array_equal(lt, want):
        return None
    return float(self_p), float(off)


def _check_inputs(em, base, length, extra=()):
    if em.dim() != 3 or em.shape[1] != N_STATES:
        raise ValueError(f"em must be [chunk, {N_STATES}, L], got "
                         f"{tuple(em.shape)}")
    L = em.shape[2]
    if base.shape != (L,) or length.shape != (L,):
        raise ValueError("base and length must be [L]")
    if em.device.type == "cuda":
        cuda_lib.require_cuda_tensor("em", em, torch.float32)
        for name, x, dt in (("base", base, torch.int32),
                            ("length", length, torch.int32), *extra):
            cuda_lib.require_cuda_tensor(name, x, dt, em.device)
    elif em.device.type != "cpu":
        raise ValueError(f"unsupported device {em.device}")


def _step_masks(base, length, k):
    t = base + k
    return t < length, t == 0


def chunk_matrices_plain(em, base, length, log_trans, log_init):
    """Plain torch version of B2."""
    chunk, S, L = em.shape
    lt = torch.as_tensor(np.asarray(log_trans, np.float32), device=em.device)
    li = torch.as_tensor(np.asarray(log_init, np.float32), device=em.device)
    eye = torch.where(torch.eye(S, dtype=torch.bool, device=em.device),
                      0.0, NEG_INF).to(torch.float32)
    M = eye[:, :, None].expand(S, S, L).clone()
    uniform = uniform_transitions(log_trans) is not None
    self_p, off = lt[0, 0], lt[0, 1]
    for k in range(chunk):
        e = em[k]                                           # [S, L]
        m, t0 = _step_masks(base, length, k)
        if uniform:
            # acc[i, j] = max(M[i, j] + self, rowmax_i + off)
            acc = torch.maximum(M + self_p, M.amax(dim=1, keepdim=True) + off)
        else:
            # acc[i, j] = max_q M[i, q] + lt[q, j]
            acc = (M[:, :, None, :] + lt[None, :, :, None]).amax(dim=1)
        reg = acc + e[None]
        t0v = (li[:, None] + e)[None].expand(S, S, L)
        M = torch.where(m, torch.where(t0, t0v, reg), M)
    return M


def forward_backtrack_plain(em, base, length, start, log_trans, log_init):
    """Plain torch version of B3."""
    chunk, S, L = em.shape
    lt = np.asarray(log_trans, np.float32)
    li = torch.as_tensor(np.asarray(log_init, np.float32), device=em.device)
    j_iota = torch.arange(S, device=em.device)[:, None].expand(S, L)
    bps = torch.empty((chunk, S, L), dtype=torch.int64, device=em.device)
    V = start.clone()
    for k in range(chunk):
        e = em[k]
        m, t0 = _step_masks(base, length, k)
        accs, args = [], []
        for j in range(S):
            a = V[0] + float(lt[0, j])
            g = torch.zeros(L, dtype=torch.int64, device=em.device)
            for i in range(1, S):
                c = V[i] + float(lt[i, j])
                better = c > a
                a = torch.maximum(a, c)
                g = torch.where(better, i, g)
            accs.append(a)
            args.append(g)
        reg = torch.stack(accs) + e
        t0v = li[:, None] + e
        bps[k] = torch.where(m & ~t0, torch.stack(args), j_iota)
        V = torch.where(m, torch.where(t0, t0v, reg), V)
    state = j_iota.clone()
    paths = torch.empty((chunk, S, L), dtype=torch.int8, device=em.device)
    for k in range(chunk - 1, 0, -1):
        paths[k] = state.to(torch.int8)
        state = torch.gather(bps[k], 0, state)
    paths[0] = state.to(torch.int8)
    prev_end = torch.gather(bps[0], 0, state).to(torch.int8)
    return paths, prev_end


def chunk_matrices(em, base, length, log_trans, log_init):
    """B2: f32 [S, S, L] chunk transfer matrices."""
    _check_inputs(em, base, length)
    if em.device.type == "cpu":
        return chunk_matrices_plain(em, base, length, log_trans, log_init)
    chunk, S, L = em.shape
    lt, li = _model_args(log_trans, log_init)
    uniform = uniform_transitions(log_trans) is not None
    lib = cuda_lib.load("viterbi", _SIGNATURES)
    if lib.viterbi_n_states() != N_STATES:
        raise RuntimeError("viterbi.cu state count differs from N_STATES")
    out = torch.empty((S, S, L), dtype=torch.float32, device=em.device)
    status = cuda_lib.launch(
        em.device, lib.viterbi_chunk_matrices,
        em.data_ptr(), base.data_ptr(), length.data_ptr(), out.data_ptr(),
        chunk, L, lt, li, int(uniform))
    cuda_lib.check(status, "viterbi_chunk_matrices")
    LAUNCHES["chunk_matrix"] += 1
    CHAINS["uniform" if uniform else "general"] += 1
    return out


def forward_backtrack(em, base, length, start, log_trans, log_init):
    """B3: (paths int8 [chunk, S, L], prev_end int8 [S, L]) from the
    chunk-start scores `start` f32 [S, L]."""
    _check_inputs(em, base, length, extra=(("start", start, torch.float32),))
    if start.shape != (em.shape[1], em.shape[2]):
        raise ValueError("start must be [S, L]")
    if em.device.type == "cpu":
        return forward_backtrack_plain(em, base, length, start, log_trans,
                                       log_init)
    chunk, S, L = em.shape
    lt, li = _model_args(log_trans, log_init)
    lib = cuda_lib.load("viterbi", _SIGNATURES)
    if not 1 <= chunk <= lib.viterbi_max_chunk():
        raise ValueError(f"chunk {chunk} outside [1, "
                         f"{lib.viterbi_max_chunk()}]: the kernel keeps a "
                         f"block's backpointers in shared memory")
    dev = em.device
    paths = torch.empty((chunk, S, L), dtype=torch.int8, device=dev)
    prev_end = torch.empty((S, L), dtype=torch.int8, device=dev)
    status = cuda_lib.launch(
        dev, lib.viterbi_forward_backtrack,
        em.data_ptr(), base.data_ptr(), length.data_ptr(), start.data_ptr(),
        paths.data_ptr(), prev_end.data_ptr(), chunk, L, lt, li)
    cuda_lib.check(status, "viterbi_forward_backtrack")
    LAUNCHES["forward_backtrack"] += 1
    return paths, prev_end


def _max_in_order(x: torch.Tensor) -> torch.Tensor:
    """Maximum over dim -2, taken with torch.maximum in index order, as
    K5 takes it, so that where -0.0 and +0.0 tie the sign comes out as in
    the kernel (a reduction's order is not specified)."""
    out = x[..., 0, :]
    for k in range(1, x.shape[-2]):
        out = torch.maximum(out, x[..., k, :])
    return out


def _maxplus(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(max,+) product of [..., S, S] matrices, a the earlier chunk:
    out[..., i, j] = max_k a[..., i, k] + b[..., k, j], one f32 add a term
    (canvas_tpu/ops/hmm.py:_maxplus_combine)."""
    return _max_in_order(a[..., :, :, None] + b[..., None, :, :])


def _associative_scan(e: torch.Tensor) -> torch.Tensor:
    """Inclusive (max,+) prefix over dim 1 of e [B, n, S, S], bracketed
    as jax.lax.associative_scan brackets it (jax/_src/lax/control_flow/
    loops.py, _scan): r[i] = e[2i] (x) e[2i+1], o = scan(r), then
    out[2i+1] = o[i], out[0] = e[0] and out[2i] = o[i-1] (x) e[2i]."""
    n = e.shape[1]
    if n < 2:
        return e
    o = _associative_scan(_maxplus(e[:, 0:n - 1:2], e[:, 1::2]))
    out = torch.empty_like(e)
    out[:, 0] = e[:, 0]
    out[:, 1::2] = o
    out[:, 2::2] = _maxplus(o[:, :(n - 1) // 2], e[:, 2::2])
    return out


def scan_combines(n_chunks: int) -> int:
    """(max,+) products in the associative scan over n_chunks matrices:
    n // 2 on the way up and (n - 1) // 2 on the way down at each level."""
    n, count = n_chunks, 0
    while n >= 2:
        count += n // 2 + (n - 1) // 2
        n //= 2
    return count


def chunk_scan_plain(mats, n_seq):
    """Plain torch version of K5: the (max,+) prefix over each sequence's
    chunk matrices as canvas_tpu's decode computes it, one
    jax.lax.associative_scan of _maxplus_combine, so that every add is
    bracketed as there and the start scores are equal bit for bit."""
    S, _, L = mats.shape
    nC = L // n_seq
    dev = mats.device
    cm = mats.reshape(S, S, n_seq, nC).permute(2, 3, 0, 1)     # [B,nC,S,S]
    scores_end = _max_in_order(_associative_scan(cm))          # [B, nC, S]
    start = torch.cat(
        [torch.zeros((n_seq, 1, S), dtype=torch.float32, device=dev),
         scores_end[:, :-1]], dim=1)
    ss = start.permute(2, 0, 1).reshape(S, L).contiguous()
    last_end = torch.argmax(scores_end[:, -1], dim=-1).to(torch.int32)
    return ss, last_end


def chunk_chase_plain(prev_end, last_end):
    """Plain torch version of K6, by pointer doubling: chunk c's end state
    is f_{c+1}(f_{c+2}(... f_{nC-1}(last_end))), with f_c(s) = prev_end of
    chunk c from end state s.  comp[c] starts as f_{c+1} (the identity for
    the last chunk) and after the round with stride d holds f_{c+1} o ...
    o f_{c+2d}: ceil(log2 nC) rounds of gathers, exact integer work equal
    to the kernel's sequential chase."""
    S, L = prev_end.shape
    B = last_end.shape[0]
    nC = L // B
    dev = prev_end.device
    pe = prev_end.to(torch.int64).reshape(S, B, nC).permute(2, 1, 0)  # [nC,B,S]
    ident = torch.arange(S, device=dev).expand(1, B, S)
    comp = torch.cat([pe[1:], ident])
    d = 1
    while d < nC:
        later = torch.cat([comp[d:], ident.expand(d, B, S)])
        comp = torch.gather(comp, 2, later)
        d *= 2
    ends = torch.gather(comp, 2, last_end.to(torch.int64)[None, :, None]
                        .expand(nC, B, 1))[:, :, 0]                # [nC, B]
    return ends.T.reshape(L).contiguous()


def _check_lanes(name, x, dtype, shape, device):
    if x.shape != shape:
        raise ValueError(f"{name} must be {list(shape)}, got "
                         f"{list(x.shape)}")
    if device.type == "cuda":
        cuda_lib.require_cuda_tensor(name, x, dtype, device)
    elif x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")


def chunk_scan(mats, n_seq):
    """K5: (chunk-start scores f32 [S, L], best last end state int32
    [n_seq]) from B2's chunk matrices f32 [S, S, L], L = n_seq * chunks
    with lane = b * chunks + c."""
    S = N_STATES
    L = mats.shape[-1]
    if n_seq < 1 or L % n_seq or L == 0:
        raise ValueError(f"{L} lanes do not make {n_seq} sequences")
    _check_lanes("mats", mats, torch.float32, (S, S, L), mats.device)
    if mats.device.type == "cpu":
        return chunk_scan_plain(mats, n_seq)
    lib = cuda_lib.load("viterbi", _SIGNATURES)
    n_chunks = L // n_seq
    ss = torch.empty((S, L), dtype=torch.float32, device=mats.device)
    last_end = torch.empty(n_seq, dtype=torch.int32, device=mats.device)
    # the levels of the tree that do not fit in the kernel's shared memory
    scratch = torch.empty(
        (n_seq, lib.viterbi_scan_scratch_mats(n_chunks), S, S),
        dtype=torch.float32, device=mats.device)
    status = cuda_lib.launch(mats.device, lib.viterbi_chunk_scan,
                             mats.data_ptr(), ss.data_ptr(),
                             last_end.data_ptr(), scratch.data_ptr(), n_seq,
                             n_chunks)
    cuda_lib.check(status, "viterbi_chunk_scan")
    LAUNCHES["chunk_scan"] += 1
    return ss, last_end


def chunk_chase(prev_end, last_end):
    """K6: each chunk's end state, int64 [L] (lane = b * chunks + c), from
    B3's prev_end int8 [S, L] and K5's last_end int32 [B]."""
    S = N_STATES
    L = prev_end.shape[-1]
    n_seq = last_end.shape[0] if last_end.dim() == 1 else 0
    if n_seq < 1 or L % n_seq or L == 0:
        raise ValueError(f"{L} lanes do not make {n_seq} sequences")
    _check_lanes("prev_end", prev_end, torch.int8, (S, L), prev_end.device)
    _check_lanes("last_end", last_end, torch.int32, (n_seq,),
                 prev_end.device)
    if prev_end.device.type == "cpu":
        return chunk_chase_plain(prev_end, last_end)
    lib = cuda_lib.load("viterbi", _SIGNATURES)
    sel = torch.empty(L, dtype=torch.int64, device=prev_end.device)
    status = cuda_lib.launch(prev_end.device, lib.viterbi_chunk_chase,
                             prev_end.data_ptr(), last_end.data_ptr(),
                             sel.data_ptr(), n_seq, L // n_seq)
    cuda_lib.check(status, "viterbi_chunk_chase")
    LAUNCHES["chunk_chase"] += 1
    return sel
