"""Losses (counterpart of mmgl_tpu/train/losses.py:22-245).

Encoder-decoder (T5) CE over the labels, unshifted (the decoder inputs are
the labels shifted right), -100 excluded. Decoder-only CE over the whole shifted sequence, prompt and pads included,
with -100 positions (image splices) excluded, plus the summary loss over the
label span with pads dropped (run_generation.py:470-481 in the reference),
from one per-token CE pass.

The per-token CE is ``_TokenCE``, the counterpart of the custom-VJP
``_ce_core``: an fp32 logsumexp over the logits in their own dtype, saving
only the logits and the (B, T) logsumexp, never an fp32 copy of the (B, T, V)
logits; the backward recomputes softmax minus one-hot in one pass and
returns the gradient in the logits' dtype. ``fused=False`` (``--fused_ce
false``) is the JAX ``_ce_plain``: plain autograd of the fp32 logsumexp
minus the gold logit, for the decoder-only losses only.

``chunked_causal_losses`` (``--chunked_ce n``) takes the pre-head hidden
states and the tied table in place of the logits: ``_ChunkedCE`` streams
the head over n vocab chunks, with an online logsumexp, so the (B, T, V)
logits are never materialised; its backward recomputes each chunk's logits
and accumulates dhidden and the table's gradient. The chunk products are
plain matmuls in fp32 (the JAX package's ``preferred_element_type``), left
to the library as the JAX package leaves them to XLA.

On a mesh (parallel/): where the tied table is vocab-parallel, the logits
(and the chunked CE's table) are this rank's vocab columns, given by
``vocab`` (a ``VocabShard``). Each form then takes its max and sum-exp over
the model group (an all-reduce of the rows' max, then one of the sum and
the label's logit, which only the rank owning the label holds), never
gathering the (B, T, V) logits; the backward is each rank's own columns.
Over a data group (``data``) each mean divides this rank's sum by the
valid count of the whole global batch, so the ranks' losses sum to the JAX
package's mean over it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from mmgl_tpu_torch.parallel.collectives import (VocabShard, all_gather_cat,
                                                 all_reduce, copy_to_group,
                                                 group_size,
                                                 reduce_from_group)

IGNORE_INDEX = -100


def _sharded(vocab: Optional[VocabShard]) -> bool:
    return vocab is not None and group_size(vocab.group) > 1


def _local_labels(labels: torch.Tensor, rows: int,
                  vocab: Optional[VocabShard]):
    """(valid, the label's column here (0 where elsewhere), whether this
    rank holds it)."""
    valid = labels >= 0
    local = labels.clamp(min=0) - (vocab.start if vocab is not None else 0)
    inside = valid & (local >= 0) & (local < rows)
    return valid, torch.where(inside, local, torch.zeros_like(local)), inside


class _TokenCE(torch.autograd.Function):
    """Per-token CE in fp32 from native-dtype logits; labels < 0 give 0.
    ``vocab``: the logits are that shard's columns; the rows' max is then
    all-reduced over its group, and their sum-exp and the label's logit
    in one all-reduce (None: the whole vocabulary, no collective)."""

    @staticmethod
    def forward(ctx, logits, labels, vocab):
        group = vocab.group if vocab is not None else None
        valid, safe, inside = _local_labels(labels, logits.shape[-1], vocab)
        # the max in the logits' dtype is exact; exp and sum run in fp32
        m = all_reduce(logits.amax(dim=-1).float(), group, dist.ReduceOp.MAX)
        s = torch.exp(logits.float() - m[..., None]).sum(dim=-1)
        gold = torch.gather(logits, -1, safe[..., None])[..., 0].float()
        gold = torch.where(inside, gold, torch.zeros_like(gold))
        s, gold = all_reduce(torch.stack([s, gold]), group)
        logz = torch.log(s) + m
        ctx.save_for_backward(logits, safe, inside, valid, logz)
        return torch.where(valid, logz - gold, torch.zeros_like(logz))

    @staticmethod
    def backward(ctx, grad):
        logits, safe, inside, valid, logz = ctx.saved_tensors
        g = torch.where(valid, grad, torch.zeros_like(grad)).float()
        # one fp32 working copy, updated in place (copy=True: never the
        # saved fp32 logits themselves)
        p = logits.to(torch.float32, copy=True).sub_(logz[..., None]).exp_()
        p.scatter_add_(-1, safe[..., None], -inside[..., None].float())
        return p.mul_(g[..., None]).to(logits.dtype), None, None


def _plain_ce(logits: torch.Tensor, labels: torch.Tensor,
              vocab: Optional[VocabShard] = None) -> torch.Tensor:
    """``_ce_plain``: the same CE by plain autograd over an fp32 copy of
    the logits; labels < 0 give 0. ``vocab``: as ``_TokenCE``'s; each
    rank's logsumexp is then combined over its group (its max all-reduced,
    the sum through ``reduce_from_group``), which without a group is the
    logsumexp itself, bit for bit."""
    group = vocab.group if vocab is not None else None
    valid, safe, inside = _local_labels(labels, logits.shape[-1], vocab)
    logits32 = logits.float()
    lse = torch.logsumexp(logits32, dim=-1)
    m = all_reduce(lse.detach().clone(), group, dist.ReduceOp.MAX)
    s = reduce_from_group(torch.exp(lse - m), group)
    gold = torch.gather(logits32, -1, safe[..., None])[..., 0]
    gold = reduce_from_group(torch.where(inside, gold,
                                         torch.zeros_like(gold)), group)
    logz = torch.log(s) + m
    return torch.where(valid, logz - gold, torch.zeros_like(logz))


def vocab_argmax(logits: torch.Tensor,
                 vocab: Optional[VocabShard] = None) -> torch.Tensor:
    """``argmax`` over the last dim, of vocab-sharded logits too: each
    rank's max and its index, all-gathered over the model group (the
    (value, index) pairs, never the logits); ties go to the lowest index,
    as ``argmax`` takes them."""
    idx = torch.argmax(logits, dim=-1)
    if not _sharded(vocab):
        return idx
    val = torch.gather(logits, -1, idx[..., None])[..., 0].float()
    vals = all_gather_cat(val[None], vocab.group, 0)
    idxs = all_gather_cat((idx + vocab.start)[None], vocab.group, 0)
    best = torch.argmax(vals, dim=0)
    return torch.gather(idxs, 0, best[None])[0]


def token_ce(logits: torch.Tensor, labels: torch.Tensor, fused: bool = True,
             vocab: Optional[VocabShard] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token CE in fp32 and its validity; labels < 0 give 0. ``vocab``:
    the logits are that shard's columns."""
    ce = (_TokenCE.apply(logits, labels, vocab) if fused
          else _plain_ce(logits, labels, vocab))
    return ce, labels >= 0


def _share(total: torch.Tensor, count: torch.Tensor, data) -> torch.Tensor:
    """total / count, the count summed over the data group ``data``: this
    rank's share of the global batch's mean."""
    if group_size(data) > 1:
        count = all_reduce(count.clone(), data)
    return total / count.clamp(min=1)


def seq2seq_loss(logits: torch.Tensor, labels: torch.Tensor,
                 vocab: Optional[VocabShard] = None, data=None
                 ) -> torch.Tensor:
    """Unshifted CE (decoder inputs already shifted right)."""
    ce, valid = token_ce(logits, labels, vocab=vocab)
    return _share(ce.sum(), valid.sum(), data)


def _span_losses(ce: torch.Tensor, labels: torch.Tensor,
                 max_input_length: int, pad_token_id: int, data=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lm_loss, summary_loss) of the shifted per-token CE: the mean over
    the valid labels, and over the label span with pads dropped."""
    shifted = labels[:, 1:]
    valid = shifted >= 0
    loss = _share(ce.sum(), valid.sum(), data)
    pos = torch.arange(ce.shape[1], device=ce.device)
    span = valid & (pos[None, :] >= max_input_length) & (shifted
                                                          != pad_token_id)
    s_loss = _share((ce * span).sum(), span.sum(), data)
    return loss, s_loss


def causal_losses(logits: torch.Tensor, labels: torch.Tensor,
                  max_input_length: int, pad_token_id: int,
                  fused_ce: bool = True, vocab: Optional[VocabShard] = None,
                  data=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lm_loss, summary_loss): logits[:, :-1] predict labels[:, 1:]."""
    ce, _ = token_ce(logits[:, :-1], labels[:, 1:], fused=fused_ce,
                     vocab=vocab)
    return _span_losses(ce, labels, max_input_length, pad_token_id, data)


def _chunk_width(v: int, n_chunks: int) -> int:
    """``_pad_vocab``'s chunk width: ceil(V / n_chunks) rounded up to a
    multiple of 128."""
    vc = -(-v // n_chunks)
    return vc + (-vc) % 128


def _chunk_rows(emb: torch.Tensor, c: int, vc: int) -> torch.Tensor:
    """Chunk c of the (V, D) table, (vc, D): rows [c vc, (c + 1) vc), zero
    rows past V. Only a chunk that reaches past V is copied."""
    rows = emb[c * vc:(c + 1) * vc]
    if rows.shape[0] < vc:
        rows = torch.cat([rows, rows.new_zeros(vc - rows.shape[0],
                                               emb.shape[1])])
    return rows


def _chunk_logits(h32: torch.Tensor, emb_c: torch.Tensor, base: int,
                  v: int) -> torch.Tensor:
    """One chunk's fp32 logits, (B, T, vc), from the fp32 hidden states;
    -inf past the vocabulary."""
    logits = h32 @ emb_c.float().T
    past = torch.arange(base, base + emb_c.shape[0],
                        device=logits.device) >= v
    return logits.masked_fill(past, float("-inf"))


class _ChunkedCE(torch.autograd.Function):
    """Per-token CE of ``hidden @ emb.T`` in fp32 over ``n_chunks`` vocab
    chunks (``chunked_ce``, mmgl_tpu/train/losses.py:133-228); labels < 0
    give 0."""

    @staticmethod
    def forward(ctx, hidden, emb, labels, n_chunks, vocab=None):
        v = emb.shape[0]
        vc = _chunk_width(v, n_chunks)
        valid = labels >= 0
        # the label's row of this table (its shard's, where vocab-parallel)
        safe = labels.clamp(min=0) - (vocab.start if vocab is not None
                                      else 0)
        shape = hidden.shape[:-1]
        m = hidden.new_full(shape, float("-inf"), dtype=torch.float32)
        s = hidden.new_zeros(shape, dtype=torch.float32)
        gold = hidden.new_zeros(shape, dtype=torch.float32)
        h32 = hidden.float()
        for c in range(n_chunks):
            base = c * vc
            logits = _chunk_logits(h32, _chunk_rows(emb, c, vc), base, v)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            s = s * torch.exp(m - m_new) + torch.exp(
                logits - m_new[..., None]).sum(dim=-1)
            m = m_new
            in_chunk = (safe >= base) & (safe < base + vc) & (safe < v)
            idx = (safe - base).clamp(0, vc - 1)
            g = torch.gather(logits, -1, idx[..., None])[..., 0]
            gold = gold + torch.where(in_chunk, g, torch.zeros_like(g))
        if _sharded(vocab):
            m_all = all_reduce(m.clone(), vocab.group, dist.ReduceOp.MAX)
            s, gold = all_reduce(torch.stack([s * torch.exp(m - m_all),
                                              gold]), vocab.group)
            m = m_all
        logz = torch.log(s) + m
        ctx.n_chunks = n_chunks
        ctx.save_for_backward(hidden, emb, safe, valid, logz)
        return torch.where(valid, logz - gold, torch.zeros_like(logz))

    @staticmethod
    def backward(ctx, grad):
        hidden, emb, safe, valid, logz = ctx.saved_tensors
        want_h, want_e = ctx.needs_input_grad[:2]
        v = emb.shape[0]
        vc = _chunk_width(v, ctx.n_chunks)
        g = torch.where(valid, grad, torch.zeros_like(grad)).float()
        h32 = hidden.float()
        dh = torch.zeros_like(h32) if want_h else None
        demb = []
        for c in range(ctx.n_chunks):
            base = c * vc
            rows = _chunk_rows(emb, c, vc)
            p = torch.exp(_chunk_logits(h32, rows, base, v)
                          - logz[..., None])
            in_chunk = (safe >= base) & (safe < base + vc) & (safe < v)
            idx = (safe - base).clamp(0, vc - 1)[..., None]
            p.scatter_add_(-1, idx, -in_chunk[..., None].float())
            # the chunk's dlogits in the hidden states' dtype, as the JAX
            # package rounds them before the two products
            dlog = (p * g[..., None]).to(hidden.dtype).float()
            if want_h:
                dh += dlog @ rows.float()
            if want_e:
                demb.append(dlog.reshape(-1, vc).T
                            @ h32.reshape(-1, h32.shape[-1]))
        dh = dh.to(hidden.dtype) if want_h else None
        de = (torch.cat(demb)[:v].to(emb.dtype) if want_e else None)
        return dh, de, None, None, None


def chunked_causal_losses(hidden: torch.Tensor, emb: torch.Tensor,
                          labels: torch.Tensor, max_input_length: int,
                          pad_token_id: int, n_chunks: int = 8,
                          vocab: Optional[VocabShard] = None, data=None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lm_loss, summary_loss) as ``causal_losses``, from the pre-head
    hidden states and the tied table: hidden[:, :-1] predict labels[:, 1:]
    (``chunked_causal_losses``). ``vocab``: ``emb`` is that shard's rows,
    each rank chunks its own, and the hidden states' gradient is summed
    over the group."""
    h = hidden[:, :-1]
    if _sharded(vocab):
        h = copy_to_group(h, vocab.group)
    else:
        vocab = None
    ce = _ChunkedCE.apply(h, emb, labels[:, 1:], n_chunks, vocab)
    return _span_losses(ce, labels, max_input_length, pad_token_id, data)
