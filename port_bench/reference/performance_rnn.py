"""Plain reference of PerformanceRNN (Oore et al. 2018, after
djosix/Performance-RNN-PyTorch) as the configuration states it, for the
benchmark's comparison of served tokens.

From the reference implementation's equations
(mg/model/PerformanceRNN/network.py:15-154):

* a step's input: [event embedding (event_dim wide) | default flag |
  control] -> Linear(event_dim + 1 + control_dim, hidden) ->
  LeakyReLU(0.1); a request with a control has flag 0,
* num_layers GRU cells (torch.nn.GRU's gates): r = s(x W_ir + b_ir + h
  W_hr + b_hr), z likewise, n = tanh(x W_in + b_in + r (h W_hn + b_hn)),
  h' = (1 - z) n + z h,
* the initial hidden from the latent: tanh(Linear(init_dim, layers *
  hidden)), element j of layer l at j + l * hidden,
* the head reads the hidden states of all layers, concatenated in
  layer order: Linear(layers * hidden, event_dim).

Parameters are a dict under the reference state-dict names
(``event_embedding.weight``, ``inithid_fc.*``, ``concat_input_fc.*``,
``gru.weight_ih_l{k}``, ..., ``output_fc.*``).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from .precision import Arith


@torch.no_grad()
def served_logits(p: Dict[str, torch.Tensor], seqs: List[np.ndarray],
                  controls: np.ndarray, inits: np.ndarray, cfg: Dict,
                  ar: Arith, device) -> List[torch.Tensor]:
    """Logits [len - 1, event_dim] of each sequence (prompt + served)
    after each of its first len - 1 tokens, the rows stepped together
    (a row past its end idles)."""
    n = len(seqs)
    hd, nl = cfg["hidden_dim"], cfg["num_layers"]
    lens = [len(s) - 1 for s in seqs]
    steps = max(lens)
    tok = torch.zeros(n, steps, dtype=torch.long, device=device)
    for i, s in enumerate(seqs):
        tok[i, :lens[i]] = torch.as_tensor(np.asarray(s[:-1]),
                                           dtype=torch.long)
    ctrl = torch.as_tensor(controls, dtype=torch.float32, device=device)
    init = torch.as_tensor(inits, dtype=torch.float32, device=device)
    h0 = torch.tanh(ar.linear(init, p["inithid_fc.weight"],
                              p["inithid_fc.bias"]))
    h = [h0[:, k * hd:(k + 1) * hd] for k in range(nl)]
    flag = torch.zeros(n, 1, device=device)
    emb = p["event_embedding.weight"]
    out = torch.empty(n, steps, cfg["event_dim"], device=device)
    for t in range(steps):
        x = torch.cat([emb[tok[:, t]], flag, ctrl], dim=-1)
        x = F.leaky_relu(ar.linear(x, p["concat_input_fc.weight"],
                                   p["concat_input_fc.bias"]), 0.1)
        for k in range(nl):
            gi = ar.linear(x, p[f"gru.weight_ih_l{k}"], p[f"gru.bias_ih_l{k}"])
            gh = ar.linear(h[k], p[f"gru.weight_hh_l{k}"],
                           p[f"gru.bias_hh_l{k}"])
            r = torch.sigmoid(gi[:, :hd] + gh[:, :hd])
            z = torch.sigmoid(gi[:, hd:2 * hd] + gh[:, hd:2 * hd])
            c = torch.tanh(gi[:, 2 * hd:] + r * gh[:, 2 * hd:])
            h[k] = (1 - z) * c + z * h[k]
            x = h[k]
        out[:, t] = ar.linear(torch.cat(h, dim=-1), p["output_fc.weight"],
                              p["output_fc.bias"])
    return [out[i, :lens[i]] for i in range(n)]
