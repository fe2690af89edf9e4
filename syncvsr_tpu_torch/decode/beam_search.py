"""Hybrid CTC/attention beam search over a batch of utterances (port of
``syncvsr_tpu/decode/beam_search.py``, which the JAX package vmaps over the
bucket).

Static beam width W, P pre-beam candidates per hypothesis scored by the CTC
prefix DP, and the score

    total = w_dec * logp_dec + w_ctc * (psi - s_prev) + penalty + w_lm * logp_lm

(w_dec = 1 - ctc_weight, w_ctc = ctc_weight), an alive/finished split with
2W candidates a step, and eos forced on the last step. The tensors are
[B, W, ...] (the model's side flattens them to N = B x W rows).

Two things make the pools equal to the JAX package's and not only the best
hypothesis:

- **Top-k order.** ``jax.lax.top_k`` breaks ties by the lower index and
  ``torch.topk`` does not; the beam is full of exact ties (at f32,
  ``LOGZERO + logp == LOGZERO``: the dead rows of the first steps and the
  unfilled finished pool), so every top-k here is a stable descending sort.
- **The loop.** Under vmap, the while-loop runs while any row's condition
  holds, and a row whose condition is false keeps its state. Here a
  per-row ``active`` mask is read once a step on the host (the loop's only
  host read); the rows it drops keep their pools, scores and step count.
  Their cache, CTC and LM states go on changing: a dropped row never runs
  again (its condition stays false in every later stage), so nothing reads
  them.

The loop runs in stages whose cache capacity grows geometrically (64 ->
256 -> ... -> max_len + 2, ``grow_cache`` between stages, for the
decoder's and the TransformerLM's cache); shapes are static inside a stage.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from syncvsr_tpu_torch.decode.ctc_prefix import LOGZERO, CTCPrefixScorer, CTCPrefixState

Tensor = torch.Tensor


@dataclass(frozen=True)
class BeamSearchConfig:
    beam_size: int = 40
    pre_beam_ratio: float = 1.5
    ctc_weight: float = 0.1
    lm_weight: float = 0.0
    penalty: float = 0.0
    blank: int = 0
    # espnet's length-ratio knobs: with maxlenratio > 0 a row stops after
    # floor(maxlenratio * valid frames) steps (at most max_len); minlenratio
    # blocks eos, but on the forced last step, until floor(minlenratio *
    # valid frames) inner tokens are out
    maxlenratio: float = 0.0
    minlenratio: float = 0.0

    @property
    def pre_beam_size(self) -> int:
        return int(self.pre_beam_ratio * self.beam_size)


class BeamState(NamedTuple):
    alive_seq: Tensor    # [B, W, L]
    alive_score: Tensor  # [B, W]
    alive_last: Tensor   # [B, W]
    cache: Any           # decoder K/V cache, leading axis N = B x W
    ctc: CTCPrefixState
    lm_state: Any
    fin_seq: Tensor      # [B, W, L]
    fin_score: Tensor    # [B, W]
    fin_len: Tensor      # [B, W]


def _stage_bounds(l_max: int, first: int = 64, factor: int = 4) -> list:
    """Geometric cache-capacity schedule for staged decoding."""
    bounds, b = [], first
    while b < l_max:
        bounds.append(b)
        b *= factor
    bounds.append(l_max)
    return bounds


def stable_topk(x: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """The k largest along the last axis, ties to the lower index
    (``jax.lax.top_k``'s order)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _map_state(fn, state):
    """``fn`` over the tensors of a cache or LM state (a dict, a list of
    tuples, or None)."""
    if state is None:
        return None
    if isinstance(state, dict):
        return {k: fn(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_map_state(fn, s) for s in state)
    return fn(state)


def search(decoder_step: Callable[[Tensor, int, Any], Tuple[Tensor, Any]],
           init_cache: Callable[[int, int], Any],
           memory_length: Tensor,
           ctc_log_probs: Tensor,
           vocab: int,
           config: BeamSearchConfig,
           max_len: Optional[int] = None,
           lm_step: Optional[Callable[[Tensor, int, Any], Tuple[Tensor, Any]]] = None,
           lm_init: Optional[Callable[[int, int], Any]] = None,
           early_exit: bool = True,
           grow_cache: Optional[Callable[[Any, int], Any]] = None,
           grow_lm_state: Optional[Callable[[Any, int], Any]] = None,
           ) -> Tuple[BeamState, int]:
    """The beam search's final state, and the number of steps it ran.

    ``decoder_step(y_prev [N], pos, cache) -> (log-probs [N, V], cache)``
    and ``init_cache(N, capacity)`` run the decoder (the caller binds the
    encoder memory); ``lm_step``/``lm_init`` the same for shallow fusion.
    memory_length [B], ctc_log_probs [B, T, V]. ``grow_cache(cache, L)``
    enables staged decoding (``grow_lm_state`` does the same for a
    length-axis LM cache); the capacity is unobservable, since a step reads
    no position after its own."""
    b, t_enc, _ = ctc_log_probs.shape
    dev = ctc_log_probs.device
    w = config.beam_size
    n = b * w
    p = min(config.pre_beam_size, vocab)
    max_len = max_len or t_enc
    l_max = max_len + 2
    sos = eos = vocab - 1
    w_dec, w_ctc = 1.0 - config.ctc_weight, config.ctc_weight
    use_lm = lm_step is not None and config.lm_weight != 0.0

    lengths = memory_length.to(dev)
    if config.maxlenratio > 0.0:
        eff_maxlen = torch.clamp((config.maxlenratio * lengths.float()).to(torch.int32),
                                 1, max_len)
    else:
        eff_maxlen = torch.full((b,), max_len, dtype=torch.int32, device=dev)
    eff_minlen = ((config.minlenratio * lengths.float()).to(torch.int32)
                  if config.minlenratio > 0.0 else None)

    scorer = CTCPrefixScorer(ctc_log_probs, lengths, config.blank, eos)
    bounds = _stage_bounds(l_max) if grow_cache is not None else [l_max]
    lm0 = lm_init(n, bounds[0]) if lm_init is not None else None

    alive_seq = torch.full((b, w, l_max), -1, dtype=torch.long, device=dev)
    alive_seq[:, :, 0] = sos
    alive_score = torch.full((b, w), LOGZERO, device=dev)
    alive_score[:, 0] = 0.0
    state = BeamState(
        alive_seq=alive_seq, alive_score=alive_score,
        alive_last=torch.full((b, w), sos, dtype=torch.long, device=dev),
        cache=init_cache(n, bounds[0]), ctc=scorer.init_state(w), lm_state=lm0,
        fin_seq=torch.full((b, w, l_max), -1, dtype=torch.long, device=dev),
        fin_score=torch.full((b, w), LOGZERO, device=dev),
        fin_len=torch.zeros((b, w), dtype=torch.long, device=dev))
    eos_only = torch.full((vocab,), LOGZERO, device=dev)
    eos_only[eos] = 0.0
    row_base = (torch.arange(b, device=dev) * w)[:, None]

    def step(i: int, st: BeamState) -> BeamState:
        last = st.alive_last.reshape(n)
        logp_dec, cache = decoder_step(last, i, st.cache)
        weighted = w_dec * logp_dec + config.penalty                  # [N, V]
        lm_state = st.lm_state
        if use_lm:
            logp_lm, lm_state = lm_step(last, i, st.lm_state)
            weighted = weighted + config.lm_weight * logp_lm

        # pre-beam on the decoder's scores
        _, part_ids = stable_topk(logp_dec, p)                        # [N, P]
        log_psi, r_new, _ = scorer.score_partial(st.ctc, last, part_ids, i)
        # a dead prefix (s == LOGZERO) must not come back through psi - s
        valid_prefix = st.ctc.s > 0.5 * LOGZERO
        inc = torch.where(valid_prefix[:, None], w_ctc * (log_psi - st.ctc.s[:, None]),
                          LOGZERO)
        weighted = weighted.scatter_add(1, part_ids, inc)             # distinct ids a row

        total = weighted.reshape(b, w, vocab) + st.alive_score[:, :, None]
        # the last step takes eos only (>=: steps past eff_maxlen stay eos-only)
        is_last = i >= eff_maxlen - 1                                 # [B]
        total = torch.where(is_last[:, None, None], total + eos_only, total)
        if eff_minlen is not None:
            eos_ok = is_last | (i >= eff_minlen)
            total[:, :, eos] = torch.where(eos_ok[:, None], total[:, :, eos], LOGZERO)

        cand_score, cand_flat = stable_topk(total.reshape(b, w * vocab), 2 * w)
        cand_hyp = cand_flat // vocab                                 # [B, 2W]
        cand_tok = cand_flat % vocab
        cand_seq = st.alive_seq.gather(1, cand_hyp[:, :, None].expand(b, 2 * w, l_max))
        cand_seq[:, :, i + 1] = cand_tok
        is_eos = cand_tok == eos

        # finished pool: the current one merged with the eos candidates
        all_fin_score = torch.cat((st.fin_score,
                                   torch.where(is_eos, cand_score, LOGZERO)), 1)
        fin_score, fin_idx = stable_topk(all_fin_score, w)
        fin_seq = torch.cat((st.fin_seq, cand_seq), 1).gather(
            1, fin_idx[:, :, None].expand(b, w, l_max))
        fin_len = torch.cat((st.fin_len, torch.full_like(cand_tok, i + 2)), 1).gather(1, fin_idx)

        # alive: the best candidates that are not eos
        alive_score, alive_idx = stable_topk(torch.where(is_eos, LOGZERO, cand_score), w)
        hyp_sel = cand_hyp.gather(1, alive_idx)                       # [B, W]
        tok_sel = cand_tok.gather(1, alive_idx)
        alive_seq = cand_seq.gather(1, alive_idx[:, :, None].expand(b, w, l_max))
        sel = (hyp_sel + row_base).reshape(n)
        return BeamState(
            alive_seq=alive_seq, alive_score=alive_score, alive_last=tok_sel,
            cache=_map_state(lambda c: c.index_select(0, sel), cache),
            ctc=scorer.select_state(st.ctc, r_new, log_psi, part_ids, sel,
                                    tok_sel.reshape(n)),
            lm_state=_map_state(lambda c: c.index_select(0, sel), lm_state),
            fin_seq=fin_seq, fin_score=fin_score, fin_len=fin_len)

    # Early exit: with penalty <= 0 and lm_weight >= 0 no score increment is
    # positive (log-probs, and the CTC prefix score never rises under
    # extension), so once a row's best alive score cannot beat its best
    # finished one, its answer is final. A positive length bonus breaks that.
    use_early = early_exit and config.penalty <= 0.0 and config.lm_weight >= 0.0

    def cond(i_row: Tensor, st: BeamState, bound: int) -> Tensor:
        go = i_row < torch.clamp(eff_maxlen, max=bound)
        if use_early:
            go = go & (st.alive_score.max(1).values > st.fin_score.max(1).values)
        return go

    def keep(active: Tensor, new: Tensor, old: Tensor) -> Tensor:
        return torch.where(active.reshape((b,) + (1,) * (new.dim() - 1)), new, old)

    i = 0                                                  # the step of every active row
    i_row = torch.zeros(b, dtype=torch.int32, device=dev)  # each row's own count
    steps = 0
    for k, bound in enumerate(bounds):
        if k:
            state = state._replace(cache=grow_cache(state.cache, bound))
            if state.lm_state is not None and grow_lm_state is not None:
                state = state._replace(lm_state=grow_lm_state(state.lm_state, bound))
        while True:
            active = cond(i_row, state, bound)
            if not bool(active.any()):
                break
            new = step(i, state)
            state = new._replace(**{
                f: keep(active, getattr(new, f), getattr(state, f))
                for f in ("alive_seq", "alive_score", "alive_last", "fin_seq",
                          "fin_score", "fin_len")})
            i_row = i_row + active.to(torch.int32)
            i += 1
            steps += 1
    return state, steps


def best_hypothesis(state: BeamState) -> Tuple[Tensor, Tensor, Tensor]:
    """(tokens [B, L - 1] without sos and eos, padded with -1; their
    counts [B]; scores [B]) of each row's best finished hypothesis."""
    best = state.fin_score.argmax(1)                                   # first maximum
    best_len = state.fin_len.gather(1, best[:, None])[:, 0]
    l_max = state.fin_seq.shape[2]
    seq = state.fin_seq.gather(1, best[:, None, None].expand(-1, 1, l_max))[:, 0]
    keep = torch.arange(l_max - 1, device=seq.device)[None, :] < (best_len - 2)[:, None]
    tokens = torch.where(keep, seq[:, 1:], -1)
    score = state.fin_score.gather(1, best[:, None])[:, 0]
    return tokens, torch.clamp(best_len - 2, min=0), score


def beam_search(*args, **kwargs) -> Tuple[Tensor, Tensor, Tensor]:
    """``search``'s best hypothesis per row: (tokens [B, L - 1] padded with
    -1, counts [B], scores [B]); the arguments are ``search``'s."""
    return best_hypothesis(search(*args, **kwargs)[0])
