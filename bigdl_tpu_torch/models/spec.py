"""Speculative decoding: the flag rule, the greedy acceptance rule and the
self-speculative bigram draft (the port of ``bigdl_tpu/models/spec.py``).

Draft-then-verify decoding scores several tokens per forward: a cheap
draft proposes ``gamma`` tokens, the target model runs all of them in one
multi-token forward against the cached K/V (``GPT.decode_chunk`` on the
dense cache, ``GPT.paged_verify_chunk`` through the page table), and the
acceptance rule commits the longest prefix the target agrees with. At
temperature 0 the committed stream is the sequential greedy stream: the
first proposal is the argmax of the carried logits, and proposal ``j+1``
is kept only if it equals the argmax the target computed after proposals
``[0..j]``. Rejected tokens need no undo: their K/V sit past the row's
committed length, masked off and overwritten by the next verify chunk.

The draft (:class:`NGramDraft`) is a per-row ``(rows, vocab)`` int32 table
on the caller's device, learned from the prompt (``prime``) and from
committed tokens (``observe``); proposals chain table lookups. It is plain
tensor code with no kernel and no host readback.

One rule differs in form from the reference: a scatter with repeated
``(row, prev)`` pairs keeps the LAST pair in row-major order
(:func:`set_last`). The reference leaves the writer unspecified; its XLA
CPU scatter writes in order, so the last pair wins there too
(``tests/test_torch_spec.py`` holds both tables on such inputs). A CUDA
``index_put_`` would pick any writer, and two runs could then propose
differently.
"""

from __future__ import annotations

import torch

from bigdl_tpu_torch.utils.flags import get_flag


def spec_config(spec_decode=None, spec_tokens=None):
    """The draft length ``gamma`` the speculative-decoding settings ask
    for: an int >= 1, where 1 means speculation is off (the default).
    Explicit arguments win over the environment
    (``BIGDL_TPU_SPEC_DECODE`` enables, ``BIGDL_TPU_SPEC_TOKENS`` sizes
    the draft, default 4)."""
    if spec_decode is None:
        spec_decode = get_flag("BIGDL_TPU_SPEC_DECODE", False, bool)
    if not spec_decode:
        return 1
    if spec_tokens is None:
        spec_tokens = get_flag("BIGDL_TPU_SPEC_TOKENS", 4, int)
    return max(int(spec_tokens), 1)


def _at(x, idx):
    """Row ``b`` of ``x`` (B, C, ...) at column ``idx[b]``."""
    return x[torch.arange(x.shape[0], device=x.device), idx]


def accept_counts(proposed, verify_logits):
    """Greedy acceptance over one verify chunk: ``proposed`` (B, C) draft
    tokens whose first column is the argmax of the carried logits (always
    accepted), ``verify_logits`` (B, C, V) the target's logits, position
    ``j`` conditioned on proposals ``[0..j]``. Returns ``(acc, carry)``:
    ``acc`` (B,) int32 in [1, C], the longest agreeing prefix, and
    ``carry`` (B, V), the logits row at ``acc - 1`` (the next first
    token's distribution)."""
    greedy = torch.argmax(verify_logits, dim=-1).to(torch.int32)
    match = (proposed[:, 1:].to(torch.int32) == greedy[:, :-1]).to(
        torch.int32)
    acc = (1 + torch.cumprod(match, dim=1).sum(dim=1)).to(torch.int32)
    return acc, _at(verify_logits, acc.long() - 1)


def accept_serving(proposed, verify_logits, sampled=None, live=None):
    """:func:`accept_counts` for the serving slot batch: ``sampled`` rows
    (bool (B,)) commit exactly their first token (drawn from the carried
    distribution by ``select_tokens``), rows not ``live`` commit nothing.
    Returns ``(adv, carry)``: ``adv`` (B,) int32 in [0, C] and ``carry``
    read at ``max(adv, 1) - 1``, so a frozen row carries a well-defined
    (unused) logits row."""
    acc, _ = accept_counts(proposed, verify_logits)
    adv = acc if sampled is None else torch.where(sampled,
                                                  torch.ones_like(acc), acc)
    if live is not None:
        adv = torch.where(live, adv, torch.zeros_like(adv))
    adv = adv.to(torch.int32)
    return adv, _at(verify_logits, adv.long().clamp_min(1) - 1)


def commit(draft, table, props, adv, carry, last, logits):
    """The bookkeeping after acceptance that ``generate`` and the slot
    managers share: ``draft`` learns the committed (prev, tok) pairs of
    ``props`` (B, C) into ``table`` (``last`` (B,) is each row's token
    before ``props[:, 0]``), and each row that committed (``adv`` > 0)
    takes its last committed token and the ``carry`` logits. Returns
    ``(last, logits, host)``, ``host`` the proposals with ``adv`` appended
    as one (B, C + 1) int32 numpy array: the iteration's one readback."""
    iota = torch.arange(props.shape[1], device=props.device)[None, :]
    prevs = torch.cat([last[:, None], props[:, :-1]], dim=1)
    draft.observe(table, prevs, props, iota < adv[:, None])
    keep = adv > 0
    last = torch.where(keep, _at(props, adv.long().clamp_min(1) - 1), last)
    logits = torch.where(keep[:, None], carry.to(logits.dtype), logits)
    return last, logits, torch.cat([props, adv[:, None]], dim=1).cpu().numpy()


def set_last(state, rows, cols, vals):
    """``state[rows[i], cols[i]] = vals[i]`` in place for every in-bounds
    pair; out-of-bounds pairs (a row past the table, the ``vocab_size``
    sentinel column) are dropped, and of repeated pairs the last in
    row-major order wins. Every write carries its key's final value, so
    the one ``index_put_`` is deterministic on any device, without a
    readback. Returns ``state``."""
    n_rows, vocab = state.shape
    size = n_rows * vocab
    rows, cols = rows.reshape(-1).long(), cols.reshape(-1).long()
    vals = vals.reshape(-1).to(state.dtype)
    if rows.numel() == 0:
        return state
    ok = (rows >= 0) & (rows < n_rows) & (cols >= 0) & (cols < vocab)
    key = torch.where(ok, rows * vocab + cols, torch.full_like(rows, size))
    skey, order = torch.sort(key, stable=True)
    # each pair's key's last position in the sorted keys: the stable sort
    # keeps equal keys in their original order
    final = vals[order[torch.searchsorted(skey, key, right=True) - 1]]
    # dropped pairs rewrite the table's last cell with its final value
    flat = state.view(-1)
    end = torch.full((1,), size - 1, dtype=torch.long, device=key.device)
    at = (torch.searchsorted(skey, end, right=True) - 1).clamp_min(0)
    end_val = torch.where(skey[at] == end, vals[order[at]], flat[end])
    flat.index_put_((torch.where(ok, key, end),),
                    torch.where(ok, final, end_val))
    return state


class Draft:
    """The interface of a speculative draft (its state lives on the
    device; no method reads it back).

    ``init_state(rows, device)`` -> state sized for ``rows`` slots.
    ``prime(state, ids, length, rows=None, prev=None)`` -> state: learn
        from prompt tokens (``length`` (B,) valid counts; ``rows`` maps
        batch rows to state rows, values past the state's rows drop;
        ``prev`` (B,) is the token before ``ids[:, 0]`` of a chunked
        prompt, ``vocab_size`` for none).
    ``propose(state, tok0, n)`` -> (B, n) proposals whose first column is
        ``tok0`` (the already committed next token).
    ``observe(state, prevs, toks, mask, rows=None)`` -> state: learn the
        committed (prev, tok) pairs (``mask`` selects accepted positions).
    """

    def init_state(self, rows, device=None):
        raise NotImplementedError

    def prime(self, state, ids, length, rows=None, prev=None):
        raise NotImplementedError

    def propose(self, state, tok0, n):
        raise NotImplementedError

    def observe(self, state, prevs, toks, mask, rows=None):
        raise NotImplementedError


class NGramDraft(Draft):
    """Self-speculative bigram draft: a per-row ``(rows, vocab)`` int32
    table mapping the previous token to the predicted next one, updated in
    place. Repeated pairs in one update: the last wins (:func:`set_last`).
    The acceptance rule keeps the output right whatever the draft
    predicts."""

    def __init__(self, vocab_size):
        self.vocab_size = int(vocab_size)

    def init_state(self, rows, device=None):
        return torch.zeros((rows, self.vocab_size), dtype=torch.int32,
                           device=device)

    def _rows(self, rows, b, t, device):
        if rows is None:
            rows = torch.arange(b, device=device)
        rows = torch.as_tensor(rows).to(device, torch.long)
        return rows[:, None].expand(b, t)

    def prime(self, state, ids, length, rows=None, prev=None):
        dev = state.device
        ids = torch.as_tensor(ids).to(dev, torch.long)
        b, t = ids.shape
        if prev is None:
            prev = torch.full((b,), self.vocab_size, dtype=torch.long,
                              device=dev)
        prev = torch.as_tensor(prev).to(dev, torch.long)
        prevs = torch.cat([prev[:, None], ids[:, :-1]], dim=1)
        length = torch.as_tensor(length).to(dev, torch.long).reshape(-1)
        valid = torch.arange(t, device=dev)[None, :] < length[:, None]
        prevs = torch.where(valid, prevs, self.vocab_size)
        return set_last(state, self._rows(rows, b, t, dev), prevs, ids)

    def propose(self, state, tok0, n):
        rows = torch.arange(tok0.shape[0], device=state.device)
        toks = [tok0.to(state.device, torch.int32)]
        for _ in range(n - 1):
            toks.append(state[rows, toks[-1].long()])
        return torch.stack(toks, dim=1)

    def observe(self, state, prevs, toks, mask, rows=None):
        b, c = prevs.shape
        p = torch.where(mask, prevs.long(), self.vocab_size)
        return set_last(state, self._rows(rows, b, c, state.device), p,
                        toks)


__all__ = ["spec_config", "accept_counts", "accept_serving", "commit",
           "set_last", "Draft", "NGramDraft"]
