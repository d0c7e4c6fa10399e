"""Plain PyTorch oracle of kernel B2: a sum-mode embedding bag, with the
semantics of the JAX package's ``kernels/embedding_bag/ref.py::
embedding_bag_ref``."""
from __future__ import annotations

import torch


def embedding_bag_ref(table: torch.Tensor, idx: torch.Tensor,
                      weights: torch.Tensor | None = None) -> torch.Tensor:
    """table (V, d); idx (B, L) integer ids (pad: any id >= V); weights
    (B, L) or None for ones -> (B, d) = sum_l w[b,l] * table[idx[b,l]] in
    the table's dtype, summed in float32.

    As in the reference, ``valid = idx < V`` zeroes a pad's weight and ids
    are clipped into [0, V-1], so a negative id reads row 0. (The JAX
    package's Pallas path gives zero for a negative id instead; the model
    depends on this version.)"""
    v = table.shape[0]
    valid = (idx < v).to(torch.float32)
    w = valid if weights is None else weights.to(torch.float32) * valid
    rows = table[idx.clamp(0, v - 1)].to(torch.float32)      # (B, L, d)
    return torch.einsum("bl,bld->bd", w, rows).to(table.dtype)


def sorted_keys(idx: torch.Tensor, num_rows: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The backward's entry order: (keys, perm), int32 row keys sorted
    stably and the int64 positions of their entries in ``idx.reshape(-1)``.
    A key is the row an entry reads (an id < 0 reads row 0) and a pad (id
    >= V) takes the key V, so pads sort last; the stable sort keeps each
    row's entries in entry order."""
    keys = idx.reshape(-1).clamp(0, num_rows)
    return torch.sort(keys.to(torch.int32), stable=True)


def embedding_bag_bwd_ref(dout: torch.Tensor, idx: torch.Tensor,
                          weights: torch.Tensor | None,
                          num_rows: int) -> torch.Tensor:
    """The gradient of ``embedding_bag_ref`` with respect to its (V, d)
    table: dout (B, d) in the table's dtype, idx (B, L), weights (B, L)
    or None -> (V, d) in dout's dtype, summed in float32.

    As the reference's ``lookup`` differentiates: each entry adds w[b,l]
    · dout[b] to row clip(idx[b,l], 0, V-1) with w zeroed for a pad (id
    >= V), so a pad adds nothing and an id < 0 adds to row 0; every row
    no entry reads is zero."""
    v, d = num_rows, dout.shape[1]
    valid = (idx < v).to(torch.float32)
    w = valid if weights is None else weights.to(torch.float32) * valid
    contrib = w[..., None] * dout.to(torch.float32)[:, None, :]   # (B, L, d)
    grad = torch.zeros((v, d), dtype=torch.float32, device=dout.device)
    grad.index_add_(0, idx.clamp(0, v - 1).reshape(-1).to(torch.int64),
                    contrib.reshape(-1, d))
    return grad.to(dout.dtype)


def embedding_bag_bwd_emulate(dout: torch.Tensor, idx: torch.Tensor,
                              weights: torch.Tensor | None, num_rows: int,
                              chunk: int) -> torch.Tensor:
    """The backward kernel's own reduction order, in torch, with its
    bits: the entries in ``sorted_keys`` order, cut into chunks of
    ``chunk``; within a chunk each run of one key summed in entry order
    (float32, w · dout rounded before the add, as the kernel's
    ``__fmul_rn``/``__fadd_rn``); a run inside one chunk written
    directly, a run that crosses chunks left as per-chunk partials (its
    first chunk's "tail", each later chunk's "head") that the combine
    adds in chunk order; every other row zero."""
    v, d = num_rows, dout.shape[1]
    keys, perm = sorted_keys(idx, v)
    n = keys.numel()
    n_chunks = -(-n // chunk)
    vals = dout.to(torch.float32)[perm // idx.shape[1]]          # (n, d)
    if weights is not None:
        vals = weights.to(torch.float32).reshape(-1)[perm][:, None] * vals
    pad = n_chunks * chunk - n
    keys = torch.cat([keys.to(torch.int64),
                      torch.full((pad,), v, dtype=torch.int64)])
    vals = torch.cat([vals, vals.new_zeros((pad, d))])
    ks = keys.view(n_chunks, chunk)
    vs = vals.view(n_chunks, chunk, d)
    starts = torch.arange(n_chunks) * chunk
    prev = torch.where(starts > 0, keys[(starts - 1).clamp_min(0)], -1)
    head_cont = ks[:, 0] == prev
    ends = (starts + chunk).clamp_max(n)
    last = keys[ends - 1]
    nxt = torch.where(ends < n, keys[ends.clamp_max(keys.numel() - 1)], -1)
    tail_cont = (nxt == last) & (last < v)

    grad = torch.zeros((v, d), dtype=torch.float32)
    head = torch.zeros((n_chunks, d))
    tail = torch.zeros((n_chunks, d))

    def flush(sel, key, acc, from_start, continues):
        to_head = sel & from_start & head_cont
        to_tail = sel & ~to_head & continues
        direct = sel & ~to_head & ~to_tail
        head[to_head] = acc[to_head]
        tail[to_tail] = acc[to_tail]
        grad[key[direct]] = acc[direct]

    run_key = ks[:, 0].clone()
    from_start = torch.ones(n_chunks, dtype=torch.bool)
    acc = torch.zeros((n_chunks, d))
    live = run_key < v
    for j in range(chunk):
        k = ks[:, j]
        valid = k < v
        new = valid & (k != run_key)
        flush(new & live, run_key, acc, from_start, torch.zeros_like(new))
        acc = torch.where(new[:, None], 0.0, acc)
        run_key = torch.where(new, k, run_key)
        from_start &= ~new
        acc = torch.where(valid[:, None], acc + vs[:, j], acc)
    # a chunk's last run continues past it when it reached the chunk's end
    reached_end = ks[torch.arange(n_chunks), (ends - starts - 1)] < v
    flush(live, run_key, acc, from_start, tail_cont & reached_end)

    # the combine: a run whose first piece is a chunk's tail partial
    starter = tail_cont & ~(head_cont & (ks[:, 0] == last))
    for c in torch.nonzero(starter).flatten().tolist():
        total = tail[c].clone()
        k = c + 1
        while True:
            total = total + head[k]
            end_k = min((k + 1) * chunk, n)
            if not (end_k < n and int(keys[end_k]) == int(last[c])):
                break
            k += 1
        grad[int(last[c])] = total
    return grad.to(dout.dtype)
