"""Train a SentencePiece-unigram vocabulary without the sentencepiece wheel
(the port's own copy of ``syncvsr_tpu/tools/train_spm.py``).

Plays the role of the reference's spm recipe (LRS/video/spm/train.sh:1-9 +
spm_train.py, a thin wrapper over the sentencepiece C++ trainer): given a
transcript file it produces

    <prefix>.model       — a ModelProto with the piece inventory + log-prob
                           scores, parseable by data.tokenizer's pure-Python
                           loader (and therefore usable as ``data.spm_vocab``)
    <prefix>_units.txt   — the espnet units table built exactly like
                           train.sh: ``<unk> 1`` first, then the pieces that
                           actually occur when encoding the training corpus,
                           sorted, numbered from 2 (0 stays the CTC blank)

    python -m syncvsr_tpu_torch.tools.train_spm input.txt \\
        --model-prefix unigram/unigram5000 --vocab-size 5000

The trainer is the unigram LM algorithm (Kudo 2018, the one sentencepiece
implements): seed the inventory with frequent substrings, run EM over the
segmentation lattices (forward/backward expected counts), then alternate
prune-by-likelihood-loss rounds with EM until the target size is reached.
Pure Python + numpy — sized for the transcript corpora this recipe is used
on (new-language vocabs, up to a few hundred thousand short sentences), not
for the gigaword corpora the C++ trainer targets.

Note: the emitted .model contains only the piece inventory (the fields our
loader reads). It is not byte-identical to a C++-trained model (no
trainer_spec/normalizer_spec blocks), and scores come from this trainer's
EM — not guaranteed to match google/sentencepiece piece-for-piece.
"""

from __future__ import annotations

import argparse
import math
import os
import struct
from collections import Counter, defaultdict
from typing import Dict, List, Tuple

_SPACE = "▁"  # SentencePiece meta-space
# piece types (ModelProto.SentencePiece.Type)
_NORMAL, _UNKNOWN, _CONTROL = 1, 2, 3


def normalize(text: str) -> str:
    """add_dummy_prefix + whitespace folding, matching the encoder
    (data/tokenizer.py SentencePieceUnigram._normalize)."""
    text = " ".join(text.split())
    return _SPACE + text.replace(" ", _SPACE)


# ---------------------------------------------------------------------------
# Lattice DP (log-space forward/backward + Viterbi) over one sentence
# ---------------------------------------------------------------------------

def _matches(s: str, scores: Dict[str, float], max_len: int):
    """All (start, end, piece) lattice edges of s using the inventory."""
    n = len(s)
    out = []
    for i in range(n):
        top = min(max_len, n - i)
        for l in range(1, top + 1):
            cand = s[i:i + l]
            if cand in scores:
                out.append((i, i + l, cand))
    return out


def _logsumexp2(a: float, b: float) -> float:
    if a < b:
        a, b = b, a
    if b == -math.inf:
        return a
    return a + math.log1p(math.exp(b - a))


def _forward_backward(s: str, scores: Dict[str, float], max_len: int
                      ) -> Tuple[float, Dict[str, float]]:
    """Sentence log-likelihood and per-piece expected counts (E-step)."""
    n = len(s)
    edges = _matches(s, scores, max_len)
    alpha = [-math.inf] * (n + 1)
    alpha[0] = 0.0
    by_start = defaultdict(list)
    by_end = defaultdict(list)
    for i, j, piece in edges:
        by_start[i].append((j, piece))
        by_end[j].append((i, piece))
    for i in range(n):
        if alpha[i] == -math.inf:
            continue
        for j, piece in by_start[i]:
            alpha[j] = _logsumexp2(alpha[j], alpha[i] + scores[piece])
    z = alpha[n]
    counts: Dict[str, float] = {}
    if z == -math.inf:  # unsegmentable (shouldn't happen: chars are kept)
        return z, counts
    beta = [-math.inf] * (n + 1)
    beta[n] = 0.0
    for j in range(n, 0, -1):
        if beta[j] == -math.inf:
            continue
        for i, piece in by_end[j]:
            beta[i] = _logsumexp2(beta[i], beta[j] + scores[piece])
    for i, j, piece in edges:
        post = alpha[i] + scores[piece] + beta[j] - z
        if post > -30.0:
            counts[piece] = counts.get(piece, 0.0) + math.exp(post)
    return z, counts


def viterbi(s: str, scores: Dict[str, float], max_len: int) -> List[str]:
    """Best segmentation (same DP as the runtime encoder, minus unk)."""
    n = len(s)
    best = [-math.inf] * (n + 1)
    best[0] = 0.0
    back: List[Tuple[int, str]] = [(-1, "")] * (n + 1)
    for i in range(n):
        if best[i] == -math.inf:
            continue
        top = min(max_len, n - i)
        for l in range(1, top + 1):
            cand = s[i:i + l]
            sc = scores.get(cand)
            if sc is not None and best[i] + sc > best[i + l]:
                best[i + l] = best[i] + sc
                back[i + l] = (i, cand)
    out: List[str] = []
    i = n
    while i > 0:
        j, piece = back[i]
        if j < 0:
            return []  # unsegmentable
        out.append(piece)
        i = j
    return out[::-1]


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------

def _seed_inventory(sentences: List[Tuple[str, int]], max_piece_len: int,
                    seed_size: int) -> Dict[str, float]:
    """Frequent-substring seed: every substring up to max_piece_len, scored by
    log relative frequency; all single chars always kept."""
    freq: Counter = Counter()
    for s, c in sentences:
        n = len(s)
        for i in range(n):
            top = min(max_piece_len, n - i)
            for l in range(1, top + 1):
                freq[s[i:i + l]] += c
    chars = {p for p in freq if len(p) == 1}
    multi = [(p, f) for p, f in freq.items() if len(p) > 1 and f >= 2]
    # favour long frequent substrings (freq * len, the sentencepiece heuristic)
    multi.sort(key=lambda kv: (-kv[1] * len(kv[0]), kv[0]))
    keep = {p for p, _ in multi[:max(seed_size - len(chars), 0)]} | chars
    total = sum(freq[p] for p in keep)
    return {p: math.log(freq[p] / total) for p in keep}


def _em_round(sentences: List[Tuple[str, int]], scores: Dict[str, float],
              max_piece_len: int, iters: int = 2) -> Dict[str, float]:
    for _ in range(iters):
        counts: Dict[str, float] = defaultdict(float)
        for s, c in sentences:
            _, cnt = _forward_backward(s, scores, max_piece_len)
            for p, v in cnt.items():
                counts[p] += c * v
        # keep unseen single chars alive with a tiny count so every string
        # stays segmentable
        for p in scores:
            if len(p) == 1 and counts[p] <= 0.0:
                counts[p] = 1e-6
        total = sum(counts.values())
        scores = {p: math.log(v / total) for p, v in counts.items() if v > 0.0}
    return scores


def _prune(sentences: List[Tuple[str, int]], scores: Dict[str, float],
           max_piece_len: int, target: int, shrink: float) -> Dict[str, float]:
    """Drop the multi-char pieces whose removal costs the least likelihood:
    loss(p) ~= viterbi_freq(p) * (score(p) - best alt segmentation of p)."""
    vfreq: Dict[str, float] = defaultdict(float)
    for s, c in sentences:
        for p in viterbi(s, scores, max_piece_len):
            vfreq[p] += c
    losses = []
    for p in list(scores):
        if len(p) == 1:
            continue  # single chars are never pruned
        sc = scores[p]
        f = vfreq.get(p, 0.0)
        if f == 0.0:
            losses.append((0.0, p))
            continue
        # evaluate removal by popping the single key (copying the whole dict
        # per candidate is O(V^2) across a prune round)
        del scores[p]
        alt = viterbi(p, scores, max_piece_len)
        alt_score = sum(scores[q] for q in alt) if alt else -1e9
        scores[p] = sc
        losses.append((f * (sc - alt_score), p))
    losses.sort(key=lambda kv: -kv[0])
    n_chars = sum(1 for p in scores if len(p) == 1)
    want_multi = max(target - n_chars,
                     int((len(scores) - n_chars) * shrink))
    keep = {p for _, p in losses[:want_multi]}
    return {p: sc for p, sc in scores.items() if len(p) == 1 or p in keep}


def train_unigram(lines: List[str], vocab_size: int, max_piece_len: int = 8,
                  seed_size: int = 0, shrink: float = 0.75,
                  verbose: bool = False) -> List[Tuple[str, float]]:
    """Returns the final [(piece, log-prob score)] inventory of
    ``vocab_size - 3`` learned pieces (3 slots reserved for <unk>/<s>/</s>,
    the sentencepiece convention)."""
    norm = Counter(normalize(ln) for ln in lines if ln.strip())
    sentences = sorted(norm.items())
    if not sentences:
        raise ValueError("no non-empty input lines")
    n_learn = vocab_size - 3
    seed_size = seed_size or max(n_learn * 4, 1000)
    scores = _seed_inventory(sentences, max_piece_len, seed_size)
    n_chars = sum(1 for p in scores if len(p) == 1)
    if n_learn < n_chars:
        raise ValueError(
            f"vocab_size {vocab_size} smaller than the character inventory "
            f"({n_chars} chars + 3 reserved)")
    scores = _em_round(sentences, scores, max_piece_len)
    while len(scores) > n_learn:
        scores = _prune(sentences, scores, max_piece_len, n_learn, shrink)
        scores = _em_round(sentences, scores, max_piece_len)
        if verbose:
            print(f"  inventory {len(scores)}")
    pieces = sorted(scores.items(), key=lambda kv: (-kv[1], kv[0]))
    return pieces[:n_learn]


# ---------------------------------------------------------------------------
# ModelProto writer (the subset data.tokenizer's parser reads)
# ---------------------------------------------------------------------------

def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(num: int, wire: int, payload: bytes) -> bytes:
    return _varint((num << 3) | wire) + payload


def _piece_msg(text: str, score: float, ptype: int) -> bytes:
    body = _field(1, 2, _varint(len(text.encode("utf8"))) + text.encode("utf8"))
    body += _field(2, 5, struct.pack("<f", score))
    body += _field(3, 0, _varint(ptype))
    return _field(1, 2, _varint(len(body)) + body)


def write_model(path: str, pieces: List[Tuple[str, float]]) -> None:
    buf = bytearray()
    buf += _piece_msg("<unk>", 0.0, _UNKNOWN)
    buf += _piece_msg("<s>", 0.0, _CONTROL)
    buf += _piece_msg("</s>", 0.0, _CONTROL)
    for text, score in pieces:
        buf += _piece_msg(text, score, _NORMAL)
    with open(path, "wb") as f:
        f.write(bytes(buf))


def write_units(path: str, lines: List[str], model_path: str) -> int:
    """train.sh's units table: encode the corpus with the trained model,
    collect the pieces that occur, sort, number from 2 (``<unk>`` is 1)."""
    from syncvsr_tpu_torch.data.tokenizer import SentencePieceUnigram

    sp = SentencePieceUnigram.from_file(model_path)
    used = set()
    for ln in lines:
        if ln.strip():
            used.update(sp.encode_as_pieces(ln))
    used.discard(sp.unk_piece)
    with open(path, "w", encoding="utf8") as f:
        f.write("<unk> 1\n")
        for i, piece in enumerate(sorted(used), start=2):
            f.write(f"{piece} {i}\n")
    return len(used) + 1


def main():
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("input", help="transcript file, one sentence per line")
    ap.add_argument("--model-prefix", required=True,
                    help="writes <prefix>.model + <prefix>_units.txt")
    ap.add_argument("--vocab-size", type=int, default=5000)
    ap.add_argument("--max-piece-len", type=int, default=8)
    ap.add_argument("--seed-size", type=int, default=0,
                    help="substring seed inventory cap (default 4x vocab)")
    args = ap.parse_args()

    lines = open(args.input, encoding="utf8").read().splitlines()
    print(f"training unigram-{args.vocab_size} on {len(lines)} lines")
    pieces = train_unigram(lines, args.vocab_size,
                           max_piece_len=args.max_piece_len,
                           seed_size=args.seed_size, verbose=True)
    os.makedirs(os.path.dirname(args.model_prefix) or ".", exist_ok=True)
    model_path = args.model_prefix + ".model"
    write_model(model_path, pieces)
    n_units = write_units(args.model_prefix + "_units.txt", lines, model_path)
    print(f"wrote {model_path} ({len(pieces)} learned pieces) and "
          f"{args.model_prefix}_units.txt ({n_units} units); use with "
          f"data.spm_vocab={model_path}")


if __name__ == "__main__":
    main()
