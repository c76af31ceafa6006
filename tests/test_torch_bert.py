"""The port's BERT text encoder against the JAX package's, on the CPU in
f32, at toy size (2 layers, 2 heads, hidden 32, vocab 512, 64 positions,
16 tokens); the layers it brought: `Embed`, `LayerNorm`'s eps.

The JAX side runs with flash mode "always", so its attention is the Pallas
kernel in interpret mode with per-row kv_lens; the port's is the flash
kernel's plain version on the CPU. Tolerance 2e-5 absolute and relative:
both sides compute in f32 and differ in the order of their sums.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hsenet_tpu.configs as jcfg
import hsenet_tpu.ops.attention as jattn
from hsenet_tpu.models.bert import BertEncoder as JaxBert
from hsenet_torch.bridge import flax_to_torch
from hsenet_torch.models import init_random_
from hsenet_torch.models.bert import BertEncoder
from hsenet_torch.models.layers import Embed, LayerNorm
from hsenet_torch.ops import flash_attention as tfa
from test_torch_common import fill_zero_inits, to_torch_config

torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-5)
TINY_BERT = jcfg.BertConfig(
    vocab_size=512, hidden_size=32, num_layers=2, num_heads=2,
    intermediate_size=64, max_position_embeddings=64,
)
SEQ = 16


def _text(seed=0, b=3):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, TINY_BERT.vocab_size, (b, SEQ))
    mask = np.zeros((b, SEQ), np.int32)
    for row, n in enumerate((SEQ, 9, 1)[:b]):  # right-padded, one full row
        mask[row, :n] = 1
    ids = np.where(mask == 1, ids, 0)
    types = (np.arange(SEQ) >= SEQ // 2).astype(np.int32)[None].repeat(b, 0)
    return ids, mask, types


@pytest.fixture(scope="module")
def bert():
    ids, mask, _ = _text()
    jm = JaxBert(TINY_BERT)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(ids),
                        jnp.asarray(mask))
    variables = fill_zero_inits(jax.tree.map(np.asarray, variables), 1)
    # the bridge knows BERT's scan stack by its place in CLIP
    state = flax_to_torch({"language_encoder": variables["params"]})
    tm = BertEncoder(to_torch_config(TINY_BERT), device="cpu")
    tm.load_state_dict({k.split(".", 1)[1]: v for k, v in state.items()},
                       strict=True)
    return jm, variables, tm


@pytest.mark.parametrize("with_mask,with_types", [(True, False), (True, True),
                                                  (False, False)],
                         ids=["right_padded", "token_types", "no_mask"])
def test_bert_matches_jax(bert, with_mask, with_types):
    jm, variables, tm = bert
    ids, mask, types = _text(2)
    jargs = [jnp.asarray(ids), jnp.asarray(mask) if with_mask else None,
             jnp.asarray(types) if with_types else None]
    targs = [torch.as_tensor(ids), torch.as_tensor(mask) if with_mask else None,
             torch.as_tensor(types) if with_types else None]
    try:
        jattn.set_flash_mode("always")
        want = np.asarray(jm.apply(variables, *jargs))
    finally:
        jattn.set_flash_mode("auto")
    with torch.no_grad():
        got = tm(*targs)
    assert got.dtype == torch.float32 and got.shape == (3, SEQ, 32)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_bert_attention_takes_the_flash_path_with_kv_lens(bert, monkeypatch):
    """The right-padded mask reaches the flash function as per-row kv_lens
    (no (S, S) mask), once per layer."""
    _, _, tm = bert
    ids, mask, _ = _text(3)
    seen = []
    real = tfa.flash_attention_reference

    def spy(q, k, v, **kw):
        seen.append(kw["kv_lens"].tolist())
        return real(q, k, v, **kw)

    monkeypatch.setattr(tfa, "flash_attention_reference", spy)
    with torch.no_grad():
        tm(torch.as_tensor(ids), torch.as_tensor(mask))
    assert seen == [[SEQ, 9, 1]] * TINY_BERT.num_layers


def test_layer_norm_eps_and_embed_dtype():
    """BERT's LayerNorms use eps 1e-12 (the ViT's 1e-6); `Embed` returns its
    rows in the compute dtype from an f32 table."""
    tm = BertEncoder(to_torch_config(TINY_BERT), device="cpu")
    eps = {m.eps for m in tm.modules() if isinstance(m, LayerNorm)}
    assert eps == {1e-12}
    assert LayerNorm(8, device="cpu").eps == 1e-6
    emb = Embed(10, 4, dtype=torch.bfloat16, device="cpu")
    emb.weight.data = emb.weight.data.float()
    ids = torch.tensor([[1, 7]])
    out = emb(ids)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out, emb.weight[ids].to(torch.bfloat16))


def test_init_random_draws_bert_embeddings_at_std_002():
    cfg = to_torch_config(jcfg.BertConfig(vocab_size=4096, hidden_size=64,
                                          num_layers=1, num_heads=1,
                                          intermediate_size=8))
    tm = init_random_(BertEncoder(cfg, device="cpu"),
                      torch.Generator().manual_seed(0))
    word = tm.embeddings.word.weight
    assert abs(word.std().item() - 0.02) < 1e-3
    assert abs(tm.layers[0].q.weight.std().item() - 64 ** -0.5) < 1e-2
    assert torch.equal(tm.embeddings.norm.weight, torch.ones(64))
