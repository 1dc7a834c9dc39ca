"""The port's dry run (``musicgeneration_tpu_torch/graft_entry.py``) on the
CPU: ``dryrun_multichip(8, device="cpu")`` takes every multi-device path
on virtual meshes of 8 CPU shards (dp x tp train step, the sp 2 ring step
and kernel G's ring against the plain ring, dp 2 x pp 4 forward equality
and step, the CP step under dp x tp, ``generate_dp`` and ``generate_tp``
token-equal to ``generate``, the EventMelodyRNN and PoPMAG dp decodes),
as the JAX dry run (``__graft_entry__.py``) takes them on 8 virtual
devices; with 3 shards the paths that need an even or a multiple-of-4
mesh are left out, as JAX leaves them. ``entry`` builds the flagship's
forward."""

import pytest
import torch

from musicgeneration_tpu_torch.graft_entry import dryrun_multichip, entry
from tests.test_torch_dp import one_thread  # noqa: F401 (a fixture)


@pytest.mark.parametrize("n", [8, 3])
def test_dryrun_multichip_cpu(n, capsys):
    line = dryrun_multichip(n, device="cpu")
    assert capsys.readouterr().out.strip() == line
    for part in ("loss=", "cp-train", f"decode dp={n} token-equal ok",
                 "rnn dp ok popmag dp ok"):
        assert part in line
    even = ("ring-attn-train(sp=2)", "ring-kernel-g ok",
            "decode tp=2 token-equal ok", "pipeline(dp2xpp4)")
    assert all((p in line) == (n == 8) for p in even), line


def test_entry_builds_the_flagship_forward():
    fn, (model, x) = entry(device="cpu")
    assert (model.vocab_size, model.num_layers, model.d_model,
            model.max_seq, model.dtype) == (309, 6, 256, 2048, torch.bfloat16)
    assert x.shape == (6, 2048) and x.dtype == torch.long
    with torch.no_grad():  # the same forward on a short prefix
        out = fn(model, x[:1, :16])
    assert out.shape == (1, 16, 309) and torch.isfinite(out).all()
