"""Plain reference of the MusicTransformer (Huang et al. 2018) as the
flagship configuration states it, for the benchmark's comparisons.

From the published description and the reference implementation's
equations (mg/model/MusicTransformer/{network.py:14-40, layers.py:22-233,
criterion.py:28-96}):

* input: embedding * sqrt(d_model) + the sinusoid table,
* each layer: relative global attention, logits[t, s] = (q_t . k_s +
  q_t . E[max_seq - 1 - (t - s)]) / sqrt(d_head) with s > t masked by
  -1e9, softmax, times V, the out projection; post-LN (eps 1e-6) after
  the residual; a ReLU FFN; post-LN again,
* the head: Linear to the vocabulary,
* training: dropout after the input, after attention and after the FFN
  (masks given), label-smoothed cross entropy (the pad id dropped),
  clip by global norm, Adam (b1 0.9, b2 0.98, eps 1e-9) on the Noam
  schedule.

Parameters are a dict under the reference state-dict names
(``Decoder.embedding.weight``, ``Decoder.enc_layers.{i}.rga.Wq.weight``,
..., ``fc.weight``). Nothing of the program is imported: the dropout
streams and the training crops are frozen copies of their equations.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .precision import Arith

NEG = -1e9


def sinusoid(max_seq: int, d: int) -> np.ndarray:
    """Even i: sin(pos * 10000^(-i/d)); odd i: cos(pos *
    10000^(-(i-1)/d)) (layers.py:22-39)."""
    pos = np.arange(max_seq, dtype=np.float64)[:, None]
    i = np.arange(d, dtype=np.float64)[None, :]
    rate = np.exp(-np.log(10000.0) * (i - i % 2) / d)
    return np.where(i % 2 == 0, np.sin(pos * rate),
                    np.cos(pos * rate)).astype(np.float32)


def _ln(x, w, b):
    return F.layer_norm(x, (x.shape[-1],), w, b, 1e-6)


def attention(ar: Arith, q, k, v, e):
    """q, k, v: [B, H, L, dh]; e: [max_seq, dh] -> [B, H, L, dh]."""
    b, h, l, dh = q.shape
    max_seq = e.shape[0]
    t = torch.arange(l, device=q.device)
    rel = (max_seq - 1 - t[:, None] + t[None, :]).clamp(0, max_seq - 1)
    qe = ar.mm(q, e.T)                                    # [B, H, L, M]
    srel = torch.gather(qe, 3, rel.expand(b, h, l, l))
    logits = (ar.mm(q, k.transpose(-1, -2)) + srel) / math.sqrt(dh)
    logits = logits.masked_fill(t[None, :] > t[:, None], NEG)
    return ar.mm(torch.softmax(logits, dim=-1), v)


def forward(p: Dict[str, torch.Tensor], tokens: torch.Tensor, cfg: Dict,
            ar: Arith = Arith(), masks: Optional[Sequence] = None,
            rate: float = 0.0) -> torch.Tensor:
    """tokens [B, L] -> logits [B, L, V] (f32). ``masks``: the dropout
    keep masks [B, L, d], one a site in order (input, then per layer
    after attention and after the FFN), kept values scaled by 1 / (1 -
    rate)."""
    d, n_layers = cfg["d_model"], cfg["num_layers"]
    heads = d // cfg["head_dim"]
    b, l = tokens.shape
    site = iter(masks or ())

    def drop(x):
        if masks is None:
            return x
        return torch.where(next(site), x / (1.0 - rate), torch.zeros_like(x))

    pos = torch.from_numpy(sinusoid(l, d)).to(tokens.device)
    h = drop(p["Decoder.embedding.weight"][tokens] * math.sqrt(d) + pos[:l])

    def split(x):
        return x.view(b, l, heads, -1).transpose(1, 2)

    for i in range(n_layers):
        g = f"Decoder.enc_layers.{i}."

        def lin(x, name):
            return ar.linear(x, p[g + name + ".weight"], p[g + name + ".bias"])

        q, k, v = (split(lin(h, f"rga.W{c}")) for c in "qkv")
        a = attention(ar, q, k, v, p[g + "rga.E"])
        a = drop(lin(a.transpose(1, 2).reshape(b, l, d), "rga.fc"))
        out1 = _ln(a + h, p[g + "layernorm1.weight"], p[g + "layernorm1.bias"])
        f = drop(lin(torch.relu(lin(out1, "FFN_pre")), "FFN_suf"))
        h = _ln(out1 + f, p[g + "layernorm2.weight"], p[g + "layernorm2.bias"])
    return ar.linear(h, p["fc.weight"], p["fc.bias"])


def smoothed_ce_sum(logits, y, vocab: int, eps: float, pad_id: int):
    """Sum over the kept targets (not ``pad_id``) of the label-smoothed
    cross entropy, q' = (1 - eps) one-hot + eps / V; and their count."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    tgt = lp.gather(-1, y[..., None].long())[..., 0]
    ce = -((1.0 - eps) * tgt + (eps / vocab) * lp.sum(-1))
    keep = (y != pad_id).float()
    return (ce * keep).sum(), keep.sum()


# -- the training inputs, re-derived -----------------------------------------

def crop_batch(seqs: List[np.ndarray], seed: int, idx: int, rows: int,
               length: int):
    """Batch ``idx`` of the LM crop stream (reference
    MusicTransformer/data.py:42-67, batch-indexed by (seed, 0, idx)):
    ``rows`` random files longer than ``length``, a random crop of
    length + 1 from each; x = [:-1], y = [1:]."""
    ss = np.random.SeedSequence([int(seed), 0, int(idx)])
    rng = np.random.RandomState(ss.generate_state(4))
    eligible = [s for s in seqs if len(s) > length]
    picks = rng.randint(0, len(eligible), rows)
    data = np.zeros((rows, length + 1), np.int64)
    for r, pick in enumerate(picks):
        s = eligible[pick]
        start = rng.randint(0, len(s) - length)
        data[r] = s[start:start + length + 1]
    return data[:, :-1], data[:, 1:]


def dropout_masks(seed: int, step: int, shape, n_sites: int, rate: float,
                  device, rank: int = 0) -> List[torch.Tensor]:
    """The keep masks of one micro-batch's forward on data rank ``rank``:
    a generator on ``device`` seeded from (seed, 0x64726f70, step, 0) and
    the rank where it is not 0, by numpy's SeedSequence, then one uniform
    draw of ``shape`` a site, kept where < 1 - rate."""
    words = [int(seed), 0x64726F70, int(step), 0] + ([rank] if rank else [])
    w = np.random.SeedSequence(words).generate_state(2, np.uint32)
    gen = torch.Generator(device=device)
    gen.manual_seed(((int(w[0]) << 32) | int(w[1])) & ((1 << 63) - 1))
    return [torch.rand(shape, generator=gen, device=device) < 1.0 - rate
            for _ in range(n_sites)]


def noam(count: int, d: int, warmup: int) -> float:
    """d^-0.5 * min(c^-0.5, c * warmup^-1.5), c = max(count, 1), in f32
    (criterion.py:70-96)."""
    c = np.float32(max(count, 1))
    return float(np.float32(d ** -0.5) * np.minimum(
        c ** np.float32(-0.5), c * np.float32(warmup ** -1.5)))


def train_steps(p0: Dict[str, torch.Tensor], batches, cfg: Dict, tcfg: Dict,
                masks_of, ar: Arith = Arith(), block_rows: int = 8,
                rows=None, whole_count: bool = False) -> Dict:
    """Run len(batches) reference train steps from parameters ``p0``.

    ``batches``: [(x, y)] on the device; ``masks_of(step)`` the step's
    dropout masks over the whole batch; ``rows`` (default: all) the rows
    whose loss is summed, over their own count of targets or, with
    ``whole_count``, over the whole batch's. The batch runs in blocks of
    ``block_rows`` rows, gradients summed. Returns each step's loss, the
    first step's clipped gradient and every leaf after the steps."""
    params = {k: v.detach().clone().requires_grad_() for k, v in p0.items()}
    names = list(params)
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    b1, b2, eps = tcfg["adam_b1"], tcfg["adam_b2"], tcfg["adam_eps"]
    rate = tcfg["dropout_rate"]
    losses, first_grad = [], None
    for step, (x, y) in enumerate(batches):
        masks = masks_of(step)
        keep_rows = torch.arange(x.shape[0]) if rows is None else rows
        total = float((y[slice(None) if whole_count
                         else keep_rows.to(y.device)]
                       != cfg["vocab_size"] - 1).sum())
        loss = 0.0
        for k in params:
            params[k].grad = None
        for r0 in range(0, len(keep_rows), block_rows):
            sel = keep_rows[r0:r0 + block_rows].to(x.device)
            logits = forward(params, x[sel], cfg, ar,
                             [m[sel] for m in masks], rate)
            s, _ = smoothed_ce_sum(logits, y[sel], cfg["vocab_size"],
                                   tcfg["label_smoothing"],
                                   cfg["vocab_size"] - 1)
            (s / total).backward()
            loss += float(s.detach()) / total
            del logits, s
        losses.append(loss)
        with torch.no_grad():
            g = {k: params[k].grad for k in names}
            norm = float(torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g[k]) for k in names])))
            if norm >= tcfg["max_grad_norm"]:
                g = {k: v / norm * tcfg["max_grad_norm"] for k, v in g.items()}
            if first_grad is None:
                first_grad = {k: v.clone() for k, v in g.items()}
            lr = noam(step, cfg["d_model"], tcfg["warmup_steps"])
            count = step + 1
            bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
            bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
            for k in names:
                mu[k].mul_(b1).add_(g[k], alpha=1 - b1)
                nu[k].mul_(b2).addcmul_(g[k], g[k], value=1 - b2)
                upd = (mu[k] / bc1) / ((nu[k] / bc2).sqrt() + eps)
                params[k].add_(upd, alpha=-lr)
    return {"losses": losses, "first_grad": first_grad,
            "params": {k: v.detach() for k, v in params.items()}}


@torch.no_grad()
def served_logits(p: Dict[str, torch.Tensor], seqs: List[np.ndarray],
                  cfg: Dict, ar: Arith, device) -> List[torch.Tensor]:
    """Logits [len - 1, V] of each token sequence (prompt + served) after
    each of its first len - 1 tokens, one forward a sequence."""
    out = []
    for s in seqs:
        x = torch.as_tensor(np.asarray(s[:-1]), dtype=torch.long,
                            device=device)[None]
        out.append(forward(p, x, cfg, ar)[0])
    return out
