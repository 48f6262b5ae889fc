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

On CUDA tensors the wrappers launch csrc/viterbi.cu; on CPU tensors they
run the plain versions.  Both only add and take maxima in f32, in the
same order, so their outputs are equal bit for bit.  B2's bound at the
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
LAUNCHES = {"chunk_matrix": 0, "forward_backtrack": 0}
# B2's launches by the chain they ran
CHAINS = {"uniform": 0, "general": 0}

_F32P = ctypes.POINTER(ctypes.c_float)
_SIGNATURES = {
    "viterbi_chunk_matrices": [ctypes.c_void_p] * 4
    + [ctypes.c_int, ctypes.c_longlong, _F32P, _F32P, ctypes.c_int,
       ctypes.c_void_p],
    "viterbi_forward_backtrack": [ctypes.c_void_p] * 6
    + [ctypes.c_int, ctypes.c_longlong, _F32P, _F32P, ctypes.c_void_p],
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
