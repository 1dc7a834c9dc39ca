"""The port's melody codec (tokenizers/melody.py), ``LSTMStack``
(ops/lstm.py) and MelodyRNN (models/melody_rnn.py, convert.py) against
the JAX package on the same inputs: note arrays equal on fixture MIDIs
(the JAX codec run through its Python path, ``MG_NATIVE=0``), for
``skyline`` and ``top`` too; the LSTM forward and step, MelodyRNN's
logits (``attn_length`` 0 and 40) and a decode-step chain within 1e-5 in
f32, with transplanted weights; greedy ``generate`` tokens equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicgeneration_tpu.decode import DecodeParams as JDecodeParams
from musicgeneration_tpu.decode import generate as jgenerate
from musicgeneration_tpu.decode.sampling import SamplingParams as JSampling
from musicgeneration_tpu.models import MelodyRNN as JMelodyRNN
from musicgeneration_tpu.ops.lstm import LSTMStack as JLSTMStack
from musicgeneration_tpu.tokenizers import melody as jmel
from musicgeneration_tpu_torch.convert import (load_checkpoint,
                                               melody_rnn_state_dict_from_jax,
                                               model_from_state_dict)
from musicgeneration_tpu_torch.decode import (DecodeParams, SamplingParams,
                                              generate)
from musicgeneration_tpu_torch.midi import MidiFile
from musicgeneration_tpu_torch.models import MelodyRNN
from musicgeneration_tpu_torch.ops.lstm import LSTMStack
from musicgeneration_tpu_torch.tokenizers import melody as tmel

from .fixtures import (motif_piano_midi, multitrack_midi, polyphonic_midi,
                       simple_piano_midi, tempo_change_midi)

TOL = 1e-5


@pytest.fixture(scope="module")
def midis(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("melody")
    paths = {}
    for name, make in (("simple", simple_piano_midi),
                       ("motif", motif_piano_midi),
                       ("poly", polyphonic_midi),
                       ("multi", multitrack_midi),
                       ("tempo", tempo_change_midi)):
        paths[name] = str(tmp / f"{name}.mid")
        make(paths[name])
    return paths


@pytest.fixture(autouse=True)
def _python_codec(monkeypatch):
    """The JAX codec's Python path (its native parse is not ported)."""
    monkeypatch.setenv("MG_NATIVE", "0")


def _notes(midi):
    return [[(n.velocity, n.pitch, n.start, n.end) for n in inst.notes]
            for inst in midi.instruments]


@pytest.mark.parametrize("name", ["simple", "motif", "poly", "multi",
                                  "tempo"])
def test_note_arrays_equal_jax(midis, name):
    got = tmel.midi_to_note_array(midis[name])
    ref = jmel.midi_to_note_array(midis[name])
    assert got.dtype == ref.dtype == np.int16
    np.testing.assert_array_equal(got, ref)
    # one instrument only, from a parsed file
    got1 = tmel.midi_to_note_array(MidiFile(midis[name]), instr_idx=0)
    np.testing.assert_array_equal(
        got1, jmel.midi_to_note_array(midis[name], instr_idx=0))


@pytest.mark.parametrize("how", ["skyline", "top"])
@pytest.mark.parametrize("name", ["poly", "multi"])
def test_extraction_equals_jax(midis, name, how):
    got = getattr(tmel, how)(midis[name])
    ref = getattr(jmel, how)(midis[name])
    assert _notes(got) == _notes(ref)
    assert got.ticks_per_beat == ref.ticks_per_beat
    np.testing.assert_array_equal(tmel.midi_to_note_array(got),
                                  jmel.midi_to_note_array(ref))


def test_round_trip_through_note_array_to_midi(midis, tmp_path):
    arr = tmel.midi_to_note_array(midis["motif"])
    path = str(tmp_path / "back.mid")
    back = tmel.note_array_to_midi(arr, path)
    ref = jmel.note_array_to_midi(arr)
    assert _notes(back) == _notes(ref) and back.instruments[0].notes
    # the written file re-encodes to the same array up to trailing slots
    again = tmel.midi_to_note_array(path)
    n = min(len(again), len(arr)) - 2
    np.testing.assert_array_equal(again[:n], arr[:n])
    assert open(path, "rb").read()[:4] == b"MThd"


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(
        a.shape)).astype(np.float32), params)


def _lstm_pair(layers=2, in_dim=12, hidden=16, seed=0):
    jl = JLSTMStack(hidden, layers)
    xs = np.random.default_rng(seed).standard_normal((9, 3, in_dim)).astype(
        np.float32)
    zeros = (jnp.zeros((layers, 3, hidden)),) * 2
    params = _perturbed(jl.init(jax.random.PRNGKey(seed), jnp.asarray(xs),
                                zeros)["params"], seed)
    tl = LSTMStack(in_dim, hidden, layers, device="cpu")
    with torch.no_grad():
        for k in range(layers):
            for ours, theirs in (("weight_ih", "w_ih"), ("weight_hh", "w_hh"),
                                 ("bias_ih", "b_ih"), ("bias_hh", "b_hh")):
                a = torch.from_numpy(np.asarray(params[f"l{k}_{theirs}"]))
                getattr(tl, f"{ours}_l{k}").copy_(a.T if a.dim() == 2 else a)
    return jl, params, tl, xs


@pytest.mark.parametrize("with_lengths", [False, True])
def test_lstm_stack_forward_and_step_match_jax(with_lengths):
    jl, params, tl, xs = _lstm_pair()
    rng = np.random.default_rng(3)
    h0 = rng.standard_normal((2, 3, 16)).astype(np.float32)
    c0 = rng.standard_normal((2, 3, 16)).astype(np.float32)
    lengths = np.array([9, 4, 1]) if with_lengths else None
    out, (h, c) = jl.apply({"params": params}, jnp.asarray(xs),
                           (jnp.asarray(h0), jnp.asarray(c0)),
                           lengths=None if lengths is None
                           else jnp.asarray(lengths))
    t_out, (t_h, t_c) = tl(torch.from_numpy(xs),
                           (torch.from_numpy(h0), torch.from_numpy(c0)),
                           lengths=None if lengths is None
                           else torch.from_numpy(lengths))
    for a, b in ((out, t_out), (h, t_h), (c, t_c)):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                   atol=TOL, rtol=0)
    if with_lengths:
        assert float(t_out.detach()[5:, 1].abs().max()) == 0.0
    j_step, (jh, jc) = jl.apply({"params": params}, jnp.asarray(xs[0]),
                                (jnp.asarray(h0), jnp.asarray(c0)),
                                method=jl.step)
    with torch.no_grad():
        s_out, (sh, sc) = tl.step(torch.from_numpy(xs[0]),
                                  (torch.from_numpy(h0),
                                   torch.from_numpy(c0)))
    for a, b in ((j_step, s_out), (jh, sh), (jc, sc)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=TOL,
                                   rtol=0)


def test_lstm_dropout_mask_is_shared_across_steps():
    """Dropout between layers draws one [B, H] mask a layer and applies
    it at every step, as the JAX module's key (the layer folded in, not
    the step); kept values are scaled by 1 / (1 - rate)."""
    tl = LSTMStack(4, 8, 2, device="cpu", dropout_rate=0.5)
    tl.reset_parameters(torch.Generator().manual_seed(0))
    l0 = LSTMStack(4, 8, 1, device="cpu")
    l1 = LSTMStack(8, 8, 1, device="cpu")
    with torch.no_grad():
        for name in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
            getattr(l0, f"{name}_l0").copy_(getattr(tl, f"{name}_l0"))
            getattr(l1, f"{name}_l0").copy_(getattr(tl, f"{name}_l1"))
        xs = torch.randn(6, 3, 4, generator=torch.Generator().manual_seed(1))
        out0, _ = l0(xs, l0.zero_state(3))
        keep = torch.rand((3, 8), generator=torch.Generator().manual_seed(5)
                          ) < 0.5
        assert 0 < int(keep.sum()) < keep.numel()
        ref, _ = l1(torch.where(keep, out0 / 0.5, torch.zeros_like(out0)),
                    l1.zero_state(3))
        got, _ = tl(xs, tl.zero_state(3), deterministic=False,
                    generator=torch.Generator().manual_seed(5))
        plain, _ = tl(xs, tl.zero_state(3))
    torch.testing.assert_close(got, ref, atol=1e-6, rtol=0)
    assert not torch.equal(got, plain)


@pytest.fixture(scope="module", params=[0, 40], ids=["basic", "attn40"])
def melody(request):
    w = request.param
    jm = JMelodyRNN(vocab_size=130, embed_size=16, hidden_dim=24,
                    num_layers=2, attn_length=w)
    params = _perturbed(jm.init(jax.random.PRNGKey(w), jnp.zeros(
        (4, 1), jnp.int32))["params"], w + 1)
    tm = model_from_state_dict(melody_rnn_state_dict_from_jax(params),
                               device="cpu", attn_length=w)
    return jm, params, tm


def _tokens(t, b, seed=0):
    return np.random.default_rng(seed).integers(0, 130, (t, b)).astype(
        np.int32)


@pytest.mark.parametrize("with_lengths", [False, True])
def test_melody_rnn_logits_match_jax(melody, with_lengths):
    jm, params, tm = melody
    toks = _tokens(57, 3)
    lengths = np.array([57, 30, 5]) if with_lengths else None
    ref = jm.apply({"params": params}, jnp.asarray(toks),
                   None if lengths is None else jnp.asarray(lengths))
    got = tm(torch.from_numpy(toks),
             None if lengths is None else torch.from_numpy(lengths))
    assert got.shape == (57, 3, 130) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=TOL, rtol=0)
    assert isinstance(tm, MelodyRNN) and tm.family == "melody_rnn"


def test_melody_rnn_decode_chain_matches_jax_and_forward(melody):
    """50 decode steps (past the 40-step window) against JAX's
    ``decode_step`` chain and against the training forward's rows."""
    jm, params, tm = melody
    toks = _tokens(50, 2, seed=1)
    cache = jm.apply({"params": params}, 2, method=jm.init_cache)
    tc = tm.init_cache(2)
    for t in range(50):
        lj, cache = jm.apply({"params": params}, jnp.asarray(toks[t]), cache,
                             method=jm.decode_step)
        lt, tc = tm.decode_step(torch.from_numpy(toks[t]), tc)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=TOL,
                                   rtol=0)
    fwd = tm(torch.from_numpy(toks))[-1]
    np.testing.assert_allclose(lt.numpy(), fwd.detach().numpy(), atol=TOL,
                               rtol=0)
    if tm.attn_length:
        assert tc["attn_buf"].shape == (40, 2, 24)
        assert tc["attn_n"].tolist() == [50, 50]


def test_melody_rnn_greedy_generate_equals_jax(melody):
    """Greedy tokens of the port's stepwise engine equal the JAX
    engine's (its prompt bucketed to 16 with pad 0 and masked)."""
    jm, params, tm = melody
    prompt = np.array([[60, 129, 129, 128, 62, 129, 64]] * 2, np.int32)
    ref = jgenerate(jm, params, jnp.asarray(np.pad(prompt, ((0, 0), (0, 9)))),
                    jax.random.PRNGKey(0),
                    JDecodeParams(max_len=16 + 48, steps=48,
                                  sampling=JSampling(greedy=True)),
                    None, None, jnp.int32(7))
    got = generate(tm, torch.from_numpy(prompt), None,
                   DecodeParams(max_len=7 + 48, steps=48,
                                sampling=SamplingParams(greedy=True)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_melody_rnn_checkpoint_round_trip(melody, tmp_path):
    """A bare state dict loads strict; without a recorded attn_length a
    state dict with attention weights takes 40; a mismatch raises."""
    _, params, tm = melody
    path = tmp_path / "mel.pth"
    torch.save(tm.state_dict(), path)
    back = load_checkpoint(str(path), device="cpu")
    assert back.attn_length == tm.attn_length
    toks = torch.from_numpy(_tokens(9, 2))
    assert torch.equal(back(toks), tm(toks))
    sd = melody_rnn_state_dict_from_jax(params)
    with pytest.raises(ValueError, match="attn_length"):
        model_from_state_dict(sd, device="cpu",
                              attn_length=0 if tm.attn_length else 8)
    with pytest.raises(ValueError, match="no init latent"):
        tm.init_cache(1, init=torch.zeros(1, 4))


def test_melody_rnn_reference_sized_defaults():
    m = MelodyRNN(device="cpu")
    assert (m.vocab_size, m.embed_size, m.hidden_dim, m.num_layers) == (
        130, 64, 64, 2)
    assert m.lstm.dropout_rate == 0.5
    names = set(m.state_dict())
    assert "lstm.weight_ih_l1" in names and "attn_key.weight" not in names
