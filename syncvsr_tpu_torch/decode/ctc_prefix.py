"""CTC prefix scorer of the hybrid CTC/attention beam search, batched over
utterances (port of ``syncvsr_tpu/decode/ctc_prefix.py``).

The label-synchronous prefix DP runs over every frame with static shapes:
frames before the prefix's start and past an utterance's length are masked,
and only the P pre-beam candidates of each hypothesis are scored (a token
outside them falls back to slot 0 with prefix score ``LOGZERO``). The
hypotheses of all utterances lie on one axis, N = B x W, utterance-major.

Its two recurrences, R_n[t] = X_n[t] (R_n[t-1] + Phi[t-1]) and R_b[t] =
X_b[t] (R_b[t-1] + R_n[t-1]), are first-order linear recurrences in
probability space. Each runs as a scan of the log-space affine maps r ->
a r + b, composed as (a1, b1) then (a2, b2) = (a1 + a2, logaddexp(a2 + b1,
b2)), over ceil(log2 T) Hillis-Steele rounds on shifted slabs. (A cumsum +
logcumsumexp shortcut would subtract sums of ``LOGZERO = -1e10`` terms,
whose f32 spacing, 1024 at 1e10, swallows the real log-probs.) The JAX
package scans with ``jax.lax.associative_scan``, whose tree differs, so the
two agree to f32 rounding, not bitwise.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

Tensor = torch.Tensor

LOGZERO = -1.0e10


class CTCPrefixState(NamedTuple):
    r: Tensor  # [T, 2, N] forward log-probs (non-blank, blank) of each hypothesis' prefix
    s: Tensor  # [N] prefix score log psi


def _scan(a: Tensor, b: Tensor) -> Tensor:
    """The b part of the inclusive scan, along axis 0, of the affine maps
    (a[t], b[t]) applied in order of t."""
    d = 1
    while d < a.shape[0]:
        a, b = (torch.cat((a[:d], a[d:] + a[:-d])),
                torch.cat((b[:d], torch.logaddexp(a[d:] + b[:-d], b[d:]))))
        d *= 2
    return b


class CTCPrefixScorer:
    """Scorer over the CTC posteriors of a batch of utterances."""

    def __init__(self, log_probs: Tensor, lengths: Tensor, blank: int, eos: int):
        """log_probs [B, T, V] log-softmax CTC outputs; lengths [B] valid frames."""
        b, t, _ = log_probs.shape
        valid = torch.arange(t, device=log_probs.device)[None, :] < lengths[:, None]
        # padded frames: LOGZERO for every token but the blank, which scores 0
        x = torch.where(valid[..., None], log_probs.float(), LOGZERO)
        x[..., blank] = torch.where(valid, log_probs[..., blank].float(), 0.0)
        self.xt = x.transpose(0, 1).contiguous()             # [T, B, V]
        self.xb = self.xt[..., blank]                        # [T, B]
        self.B, self.T = b, t
        self.blank, self.eos = blank, eos
        # frame -1 (an empty utterance) reads the last frame, as JAX's index does
        self.end_frame = torch.remainder(lengths.long() - 1, t)

    def init_state(self, width: int) -> CTCPrefixState:
        n = self.B * width
        r_b = torch.cumsum(self.xb, 0)[:, :, None].expand(self.T, self.B, width)
        r = torch.stack((torch.full_like(r_b, LOGZERO), r_b), 1).reshape(self.T, 2, n)
        return CTCPrefixState(r=r, s=torch.zeros(n, device=r.device))

    def score_partial(self, state: CTCPrefixState, last_tokens: Tensor,
                      part_ids: Tensor, out_len: int) -> Tuple[Tensor, Tensor, Tensor]:
        """Score P candidate extensions of each of the N hypotheses.

        last_tokens [N]: the last token (sos on the first call); part_ids
        [N, P]: the candidates; out_len: tokens emitted so far. Returns
        (log_psi [N, P], the extended prefixes' scores; r_new [T, 2, N, P];
        r_sum [T, N])."""
        n, p = part_ids.shape
        t, b = self.T, self.B
        w = n // b
        r_prev = state.r
        r_sum = torch.logaddexp(r_prev[:, 0], r_prev[:, 1])                  # [T, N]
        x_n = torch.gather(self.xt, 2, part_ids.reshape(1, b, w * p).expand(t, b, w * p))
        x_n = x_n.reshape(t, n, p)                                            # [T, N, P]
        # Phi: r_sum, but r_b alone where the candidate repeats the last token
        same = part_ids == last_tokens[:, None]
        log_phi = torch.where(same[None], r_prev[:, 1, :, None], r_sum[:, :, None])

        # frames t >= start are active; t = 0 is only the seed r_n0
        start = max(out_len, 1)
        lead = torch.full((min(start, t), n, p), LOGZERO, device=x_n.device)
        r_n0 = x_n[0] if out_len == 0 else lead[0]
        # r_n: (A, B) = (x_n[t], phi[t-1] + x_n[t]) on active frames
        contrib = torch.cat((lead[1:], log_phi[start - 1:-1] + x_n[start:]))   # t = 1..T-1
        r_n = _scan(torch.cat((lead, x_n[start:])), torch.cat((r_n0[None], contrib)))
        # r_b: (A, B) = (x_b[t], r_n[t-1] + x_b[t]) on active frames
        xb = self.xb[:, :, None, None].expand(t, b, w, p).reshape(t, n, p)
        r_b = _scan(torch.cat((lead, xb[start:])),
                    torch.cat((lead, r_n[start - 1:-1] + xb[start:])))
        psi = torch.logaddexp(r_n0, torch.logsumexp(contrib, 0))
        r_new = torch.stack((r_n, r_b), 1)                                    # [T, 2, N, P]

        # eos scores the whole prefix at the utterance's last frame
        end = self.end_frame.repeat_interleave(w)
        eos_psi = r_sum.gather(0, end[None])[0]                               # [N]
        log_psi = torch.where(part_ids == self.eos, eos_psi[:, None], psi)
        log_psi = torch.where(part_ids == self.blank, LOGZERO, log_psi)
        return log_psi, r_new, r_sum

    def select_state(self, state: CTCPrefixState, r_new: Tensor, log_psi: Tensor,
                     part_ids: Tensor, hyp_idx: Tensor, tokens: Tensor) -> CTCPrefixState:
        """The DP state of the chosen (hypothesis, token) pairs: hyp_idx,
        tokens [N'], hyp_idx on the N axis. A token outside its
        hypothesis' candidates takes slot 0 and prefix score LOGZERO."""
        t, _, n, p = r_new.shape
        match = part_ids[hyp_idx] == tokens[:, None]                          # [N', P]
        found = match.any(1)
        pos = match.to(torch.int32).argmax(1)                                 # first match, else 0
        flat = hyp_idx * p + pos
        r = r_new.reshape(t, 2, n * p).index_select(2, flat)
        s = torch.where(found, log_psi.reshape(-1)[flat], LOGZERO)
        return CTCPrefixState(r=r, s=s)
