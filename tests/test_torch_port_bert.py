"""The port's BERT (mmtpu_torch.models.bert_text, checkpoints.hf_bert)
against mmtpu's and Hugging Face's on the CPU, at a tiny size (2 layers,
hidden 32, 2 heads, vocabulary 100):

- `BertModel` against `FlaxBertModel` from the same weights (flax's tree
  carried by `from_jax_variables`): variable masks, a row whose mask is all
  zero (flax's finfo.min bias gives a uniform softmax there, not NaN) and
  segment ids ≠ 0, at 1e-5 absolute; mmtpu's `BertTextEncoder` on the
  (B, 3, T) rows against the port's;
- the reader on `save_pretrained` directories written here from a seeded
  `transformers.BertModel` — `pytorch_model.bin`, `model.safetensors`
  (read without the `safetensors` package) and flax's `flax_model.msgpack`
  — against that model's forward at mmtpu's own tolerance (rtol 2e-4,
  atol 2e-5, tests/test_self_mm.py); with both a `.bin` and a
  `.safetensors` file the port takes the one `FlaxBertModel.
  from_pretrained(path, from_pt=True)` takes; the old `gamma`/`beta`
  names; a sharded index raises; `config.json` sets the architecture;
- a missing path warns with mmtpu's "RANDOMLY INITIALIZED" message and
  builds the config's sizes; a frozen encoder runs without gradient and
  without dropout in training, a fine-tuned one with both, its dropouts
  from the run's generator (the attention mask shared by batch and heads).
"""

import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmtpu_torch.checkpoints import from_jax_variables
from mmtpu_torch.checkpoints.hf_bert import read_bert_dir, read_safetensors
from mmtpu_torch.models.bert_text import BertConfig, BertModel, BertTextEncoder
from mmtpu_torch.models.rng import use_generator
from _torch_threads import few_threads  # noqa: E402,F401 — in-process comparisons only

TOL = 1e-5
SIZES = dict(vocab_size=100, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
             intermediate_size=64, max_position_embeddings=64, type_vocab_size=2)


def _hf_config(**kw):
    from transformers import BertConfig as HFConfig

    return HFConfig(**{**SIZES, **kw})


def _rows(B=4, T=10, seed=0):
    """ids, mask (one row cut at 6, one all zero), segment ids (≠ 0 in one row)."""
    g = np.random.default_rng(seed)
    ids = g.integers(0, 100, (B, T))
    mask = np.ones((B, T), np.int64)
    mask[1, 6:] = 0
    mask[min(2, B - 1)] = 0
    types = np.zeros((B, T), np.int64)
    types[B - 1, 4:] = 1
    return ids, mask, types


def _flax_and_port(seed=0):
    from transformers import FlaxBertModel

    flax_model = FlaxBertModel(_hf_config(), seed=seed)
    params = jax.tree_util.tree_map(np.asarray, flax_model.params)
    port = BertModel(BertConfig(**SIZES))
    port.load_state_dict(from_jax_variables(params, target=port), strict=True)
    return flax_model, port.eval()


def test_bert_matches_flax_bert_from_shared_weights():
    flax_model, port = _flax_and_port()
    ids, mask, types = _rows()
    want = np.asarray(flax_model(input_ids=ids, attention_mask=mask, token_type_ids=types)
                      .last_hidden_state)
    with torch.no_grad():
        got = port(torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(types))
    assert got.shape == (4, 10, 32) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_all_zero_mask_attends_uniformly():
    _, port = _flax_and_port()
    ids, mask, types = _rows()
    layer = port.encoder.layer[0].attention.self
    seen = {}

    def hook(_module, _inputs, out):
        seen["probs"] = out

    handle = layer.dropout.register_forward_hook(hook)
    with torch.no_grad():
        port(torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(types))
    handle.remove()
    probs = seen["probs"]
    torch.testing.assert_close(probs[2], torch.full_like(probs[2], 1 / 10), rtol=0, atol=1e-7)
    assert torch.all(probs[1, :, :, 6:] == 0)


def test_text_encoder_matches_mmtpus_on_bert_rows():
    from mmtpu.models.bert_text import BertTextEncoder as JaxEncoder

    jax_enc = JaxEncoder(pretrained_path="", hidden_size=32, num_hidden_layers=2,
                         num_attention_heads=2)
    ids, mask, types = _rows(B=3, T=12, seed=1)
    text = np.stack([ids, mask, types], axis=1).astype(np.float32)
    variables = jax_enc.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(text))
    want = np.asarray(jax_enc.apply(variables, jnp.asarray(text)))
    port = BertTextEncoder(pretrained_path="", hidden_size=32, num_hidden_layers=2,
                           num_attention_heads=2)
    bert = jax.tree_util.tree_map(np.asarray, variables["params"]["bert"])
    port.bert.load_state_dict(from_jax_variables(bert, target=port.bert), strict=True)
    port.train()  # frozen: eval-mode forward even while training
    got = port(torch.from_numpy(text))
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


# -- the reader ------------------------------------------------------------------

def _torch_bert(seed):
    from transformers import BertModel as HFBert

    torch.manual_seed(seed)
    return HFBert(_hf_config()).eval()


def _hf_forward(model, ids, mask, types):
    with torch.no_grad():
        return model(input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask),
                     token_type_ids=torch.from_numpy(types)).last_hidden_state.numpy()


def _port_forward(path, ids, mask, types):
    cfg, state = read_bert_dir(path)
    port = BertModel(cfg)
    port.load_state_dict({**port.state_dict(), **state}, strict=True)
    with torch.no_grad():
        return port.eval()(torch.from_numpy(ids), torch.from_numpy(mask),
                           torch.from_numpy(types)).numpy()


@pytest.mark.parametrize("fmt", ["bin", "safetensors", "flax"])
def test_reader_matches_the_torch_model(fmt, tmp_path):
    hf = _torch_bert(0)
    if fmt == "flax":
        from transformers import FlaxBertModel

        hf.save_pretrained(tmp_path / "pt", safe_serialization=False)
        FlaxBertModel.from_pretrained(str(tmp_path / "pt"), from_pt=True).save_pretrained(
            tmp_path / "bert")
        assert (tmp_path / "bert/flax_model.msgpack").exists()
    else:
        hf.save_pretrained(tmp_path / "bert", safe_serialization=fmt == "safetensors")
    ids, mask, types = _rows(B=3, T=10, seed=2)
    mask[2] = 1  # the torch model's additive mask differs from flax's on all-zero rows
    np.testing.assert_allclose(_port_forward(tmp_path / "bert", ids, mask, types),
                               _hf_forward(hf, ids, mask, types), rtol=2e-4, atol=2e-5)


def test_safetensors_reader_matches_the_package(tmp_path):
    from safetensors.torch import load_file, save_file

    g = torch.Generator().manual_seed(0)
    tensors = {"a": torch.randn(3, 4, generator=g), "b": torch.arange(5, dtype=torch.int64),
               "c": torch.randn(2, generator=g).to(torch.bfloat16), "d": torch.zeros(0, 3)}
    save_file(tensors, str(tmp_path / "t.safetensors"), metadata={"format": "pt"})
    ours, theirs = read_safetensors(tmp_path / "t.safetensors"), load_file(
        str(tmp_path / "t.safetensors"))
    assert set(ours) == set(theirs)
    for k in theirs:
        assert ours[k].dtype == theirs[k].dtype and torch.equal(ours[k], theirs[k]), k


def test_both_files_take_what_flax_takes(tmp_path):
    """A `.safetensors` from one model beside a `.bin` from another: the
    port reads the file `FlaxBertModel.from_pretrained(from_pt=True)` reads."""
    from transformers import FlaxBertModel

    _torch_bert(1).save_pretrained(tmp_path / "bert", safe_serialization=False)
    _torch_bert(2).save_pretrained(tmp_path / "st", safe_serialization=True)
    (tmp_path / "st/model.safetensors").rename(tmp_path / "bert/model.safetensors")
    flax_params = jax.tree_util.tree_map(np.asarray, FlaxBertModel.from_pretrained(
        str(tmp_path / "bert"), from_pt=True).params)
    want = from_jax_variables(flax_params)
    _, state = read_bert_dir(tmp_path / "bert")
    from_st = read_safetensors(tmp_path / "bert/model.safetensors")
    key = "embeddings.word_embeddings.weight"
    torch.testing.assert_close(state[key], want[key], rtol=0, atol=0)
    torch.testing.assert_close(state[key], from_st[key], rtol=0, atol=0)


def test_old_layernorm_names_and_prefix(tmp_path):
    hf = _torch_bert(3)
    renamed = {("bert." + k).replace("LayerNorm.weight", "LayerNorm.gamma")
               .replace("LayerNorm.bias", "LayerNorm.beta"): v
               for k, v in hf.state_dict().items()}
    renamed["cls.predictions.bias"] = torch.zeros(100)
    (tmp_path / "bert").mkdir()
    torch.save(renamed, tmp_path / "bert/pytorch_model.bin")
    (tmp_path / "bert/config.json").write_text(json.dumps(_hf_config().to_dict()))
    ids, mask, types = _rows(B=2, T=8, seed=4)
    mask[:] = 1
    np.testing.assert_allclose(_port_forward(tmp_path / "bert", ids, mask, types),
                               _hf_forward(hf, ids, mask, types), rtol=2e-4, atol=2e-5)


def test_sharded_checkpoint_raises(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps(_hf_config().to_dict()))
    (tmp_path / "pytorch_model.bin.index.json").write_text("{}")
    with pytest.raises(NotImplementedError, match="sharded"):
        read_bert_dir(tmp_path)


def test_encoder_reads_the_directory_and_its_config(tmp_path, monkeypatch):
    hf = _torch_bert(5)
    hf.save_pretrained(tmp_path / "bert_en", safe_serialization=False)
    monkeypatch.setenv("BERT_ROOT", str(tmp_path))
    enc = BertTextEncoder(pretrained_path="$BERT_ROOT/bert_en", hidden_size=768)
    assert enc.get_embedding_size() == 32  # config.json's, not the argument's
    ids, mask, types = _rows(B=2, T=8, seed=5)
    mask[:] = 1
    text = torch.from_numpy(np.stack([ids, mask, types], axis=1).astype(np.float32))
    np.testing.assert_allclose(enc.eval()(text).numpy(), _hf_forward(hf, ids, mask, types),
                               rtol=2e-4, atol=2e-5)
    from mmtpu_torch.models import seeded_init

    seeded_init(enc, 0)  # a seeded initialisation keeps the file's weights
    np.testing.assert_allclose(enc(text).numpy(), _hf_forward(hf, ids, mask, types),
                               rtol=2e-4, atol=2e-5)


def test_missing_path_warns_and_builds_the_config_sizes(tmp_path, caplog):
    with caplog.at_level(logging.WARNING):
        enc = BertTextEncoder(pretrained_path=str(tmp_path / "nope"), hidden_size=32,
                              num_hidden_layers=2, num_attention_heads=2)
    assert any("RANDOMLY INITIALIZED" in r.message for r in caplog.records)
    cfg = enc.bert.config
    assert (cfg.vocab_size, cfg.max_position_embeddings, cfg.type_vocab_size,
            cfg.intermediate_size, cfg.hidden_dropout_prob) == (30522, 512, 2, 128, 0.1)
    assert len(enc.bert.encoder.layer) == 2
    out = enc(torch.zeros(2, 3, 8))
    assert out.shape == (2, 8, 32)


def test_frozen_and_fine_tuned_training_forwards():
    ids, mask, types = _rows(B=3, T=6, seed=6)
    text = torch.from_numpy(np.stack([ids, mask, types], axis=1).astype(np.float32))
    frozen = BertTextEncoder(pretrained_path="", hidden_size=32, num_hidden_layers=2,
                             num_attention_heads=2)
    with pytest.raises(RuntimeError, match="use_generator"):
        tuned = BertTextEncoder(pretrained_path="", use_finetune=True, hidden_size=32,
                                num_hidden_layers=2, num_attention_heads=2)
        tuned.load_state_dict(frozen.state_dict())
        tuned.train()(text)
    frozen.train()
    assert not frozen.bert.training
    torch.testing.assert_close(frozen(text), frozen.eval()(text), rtol=0, atol=0)
    outs = []
    for _ in range(2):
        use_generator(tuned, torch.Generator().manual_seed(3))
        outs.append(tuned.train()(text))
    assert outs[0].requires_grad
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)  # the generator's draws
    assert not torch.allclose(outs[0], tuned.eval()(text))
    drop = tuned.bert.encoder.layer[0].attention.self.dropout
    assert drop.broadcast_dims == (0, 1) and drop.p == 0.1
