"""Zamba2-7B-Instruct (the zamba2 family): the program against the plain
reference `reference/families/zamba2.py` at smoke size in f32, those
limits failing the program in bf16, the reference against
`transformers`' own Zamba2ForCausalLM, the reference's FLOP rule against
the program's accounting, and the cell built from its files."""
import json

import pytest
import torch

import harness
import inputs
import smoke
from frozen import flops
from reference import models, ops
from reference.train import RefTrainer

CPU = torch.device("cpu")
ARCH = "zamba2-7b-instruct"
CELL = "zamba2-7b-instruct.train_4k"
OPT = json.loads((smoke.BENCH / "traffic" / "train_4k_b2.json").read_text()
                 )["optimizer"]

# Both sides compute in f32 on the same weights and tokens.  The program's
# attention (the flash kernel's plain version, its softmax over key
# blocks) and SSD (the intra-chunk kernel's plain version and the chunk
# recurrence) sum in other orders than the reference's, so they agree to
# f32 rounding carried through 5 layers and 4 invocations: measured
# logits 2.2e-6, loss below 1e-7, the widest leaf (dt_bias) 1.5e-5, the
# shared blocks', adapters' and linears' up to 6.7e-6; each limit leaves
# 4x-7x.  bf16 reads logits 6.9e-2, loss 8.9e-4, leaves up to 0.27, over
# 100x above them (test_the_limits_fail_the_program_in_bf16).
LOGIT_TOL = 1e-5        # |logits − ref| / |ref|, Frobenius
LOSS_TOL = 1e-5         # |loss − ref|, nats
GRAD_TOL = 1e-4         # |g − g_ref| / |g_ref| of each leaf: a leaf's
                        # gradient sums over every position, and the
                        # small ones (A_log, D, dt_bias) over few terms


def _sizes(dtype="float32"):
    return smoke.smoke_sizes(ARCH, dtype)


def _batch(c, seed=5):
    gen = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, c["vocab_size"], (2, 32), generator=gen)
    labels = torch.randint(0, c["vocab_size"], (2, 32), generator=gen)
    return tokens, labels


def _program(c, params, tokens, labels):
    """(logits, loss, {leaf path: gradient}) of the program's train path:
    per-layer leaves aliasing one stacked gradient buffer a leaf."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import api
    from repro_torch.models.common import tree_map
    from repro_torch.train import steps
    cfg = get_config(c["name"])
    batch = {"tokens": tokens.int(), "labels": labels.int()}
    with torch.no_grad():
        logits = api.forward(cfg, params, batch)
    grads = tree_map(torch.zeros_like, params)
    model, leaves = steps.grad_leaves(params, grads)
    loss, _ = steps.loss_fn(cfg, model, batch)
    loss.backward(inputs=leaves)
    return logits, float(loss.detach()), {lf.path: models.get(grads, lf.path)
                                 for lf in models.layout(c)}


def _reference(c, params, tokens, labels):
    ref = RefTrainer(c, OPT, params, ops.Prec("f32"))
    loss, grads = ref.grads(tokens, labels)
    return (models.all_logits(c, params, tokens, ops.Prec("f32")),
            float(loss), grads)


def _gap(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def test_program_matches_the_reference_in_f32():
    c = _sizes()
    params = inputs.weights(c, 2**35 + 17, CPU)
    tokens, labels = _batch(c)
    logits, loss, grads = _program(c, params, tokens, labels)
    want_logits, want_loss, want = _reference(c, params, tokens, labels)
    assert _gap(logits, want_logits) < LOGIT_TOL
    assert abs(loss - want_loss) < LOSS_TOL
    assert set(grads) == set(want)
    gaps = {"/".join(p): _gap(g, want[p]) for p, g in grads.items()}
    assert max(gaps.values()) < GRAD_TOL, gaps
    # each shared block's gradient sums its invocations': at smoke size,
    # (1, 2, 3, 4), two a block, so the leaves above compare those sums
    ids, nb = c["shared_block_layers"], c["num_shared_blocks"]
    assert all(sum(i % nb == b for i in range(len(ids))) >= 2
               for b in range(nb))
    g = grads[("shared_blocks", "attn", "wq")]
    assert g.shape[0] == 2 and all(float(g[b].norm()) > 0 for b in (0, 1))


def test_the_limits_fail_the_program_in_bf16():
    """The program in bf16 on the same (bf16-rounded) weights, against
    the reference in f32 on them: outside the f32 limits."""
    c16 = _sizes("bfloat16")
    params = inputs.weights(c16, 2**35 + 17, CPU)
    tokens, labels = _batch(c16)
    logits, loss, grads = _program(c16, params, tokens, labels)
    c32 = dict(c16, dtype="float32")
    want_logits, want_loss, want = _reference(c32, params, tokens, labels)
    fails = {"logits": _gap(logits, want_logits) >= LOGIT_TOL,
             "loss": abs(loss - want_loss) >= LOSS_TOL,
             "grads": max(_gap(g, want[p]) for p, g in grads.items())
             >= GRAD_TOL}
    assert any(fails.values())
    assert _gap(logits, want_logits) > 100 * LOGIT_TOL


def _hf_model(c, params):
    """transformers' Zamba2ForCausalLM at sizes c, `params` copied in
    (its Linear weights are (out, in): the transposes)."""
    from transformers import Zamba2Config, Zamba2ForCausalLM
    L, ids = c["num_layers"], c["shared_block_layers"]
    hc = Zamba2Config(
        vocab_size=c["vocab_size"], hidden_size=c["d_model"],
        num_hidden_layers=L,
        layers_block_type=["hybrid" if l in ids else "mamba"
                           for l in range(L)],
        mamba_d_state=c["ssm_state"], mamba_d_conv=c["conv_width"],
        mamba_expand=c["ssm_expand"], mamba_ngroups=c["ssm_ngroups"],
        n_mamba_heads=c["ssm_expand"] * c["d_model"] // c["ssm_head_dim"],
        chunk_size=c["ssm_chunk"], intermediate_size=c["d_ff"],
        hidden_act="gelu", num_attention_heads=c["num_heads"],
        num_key_value_heads=c["num_kv_heads"],
        num_mem_blocks=c["num_shared_blocks"], adapter_rank=c["adapter_rank"],
        use_shared_attention_adapter=False, use_mem_rope=True,
        rope_theta=c["rope_theta"], rms_norm_eps=c["norm_eps"],
        # its plain path clamps dt below at time_step_min, which neither
        # the reference nor its CUDA path (time_step_limit null) does:
        # set under any dt the draw reaches
        time_step_min=1e-9, tie_word_embeddings=True,
        attn_implementation="eager")
    torch.manual_seed(0)
    hf = Zamba2ForCausalLM(hc).float().eval()
    m, p, at = hf.model, params, {l: i for i, l in enumerate(ids)}

    def T(t):
        return t.T.contiguous()
    with torch.no_grad():
        m.embed_tokens.weight.copy_(p["embed"])
        hf.lm_head.weight.copy_(p["embed"])
        m.final_layernorm.weight.copy_(p["final_norm"])
        for l, lay in enumerate(m.layers):
            dec = lay.mamba_decoder if l in at else lay
            q = {k: v[l] for k, v in p["layers"]["mixer"].items()}
            dec.input_layernorm.weight.copy_(p["layers"]["norm"][l])
            mx = dec.mamba
            mx.in_proj.weight.copy_(T(q["in_proj"]))
            mx.conv1d.weight.copy_(T(q["conv_w"])[:, None, :])
            mx.conv1d.bias.copy_(q["conv_b"])
            for k in ("A_log", "D", "dt_bias"):
                getattr(mx, k).copy_(q[k])
            mx.norm.weight.copy_(q["out_norm"])
            mx.out_proj.weight.copy_(T(q["out_proj"]))
            if l not in at:
                continue
            i = at[l]
            b, sb = i % c["num_shared_blocks"], p["shared_blocks"]
            st = lay.shared_transformer
            assert st.block_id == b
            lay.linear.weight.copy_(T(p["linears"][i]))
            st.input_layernorm.weight.copy_(sb["norm1"][b])
            st.pre_ff_layernorm.weight.copy_(sb["norm2"][b])
            for n, w in (("q_proj", "wq"), ("k_proj", "wk"), ("v_proj", "wv"),
                         ("o_proj", "wo")):
                getattr(st.self_attn, n).weight.copy_(T(sb["attn"][w][b]))
            ff = st.feed_forward
            ff.gate_up_proj.weight.copy_(T(sb["mlp"]["gate_up"][b]))
            ff.down_proj.weight.copy_(T(sb["mlp"]["down"][b]))
            lora = ff.gate_up_proj_adapter_list[i]
            lora[0].weight.copy_(T(p["adapters"]["lora_a"][i]))
            lora[1].weight.copy_(T(p["adapters"]["lora_b"][i]))
    return hf


def test_reference_matches_transformers_zamba2(monkeypatch):
    """The reference's logits against `transformers`' Zamba2ForCausalLM
    on the same weights: the concat with e, the (hd/2)^-1/2 scale, the
    adapter, the linear, the residual taken before t and the grouped
    gated norm.  The sequence is one chunk: that model's plain path
    sums its inter-chunk decays over the target chunk (`.sum(dim=2)`
    in `torch_forward`), so it departs from the scan's recurrence, and
    from its own CUDA path, once a sequence spans two chunks; the
    reference's scan gives the same at every chunk size (checked here)."""
    monkeypatch.setenv("USE_TF", "0")
    monkeypatch.setenv("USE_FLAX", "0")
    pytest.importorskip("transformers")
    c = dict(_sizes(), ssm_chunk=32)
    params = inputs.weights(c, 2**35 + 3, CPU)
    tokens, _ = _batch(c, seed=1)
    with torch.no_grad():
        want = _hf_model(c, params)(tokens, use_cache=False).logits
    got = models.all_logits(c, params, tokens, ops.Prec("f32"))
    # f32 on both sides, 5 layers: measured 2.8e-6
    assert _gap(got, want) < 1e-5
    chunked = models.all_logits(dict(c, ssm_chunk=8), params, tokens,
                                ops.Prec("f32"))
    assert _gap(chunked, got) < 1e-5


def test_reference_flops_equal_the_programs_accounting():
    """The family's FLOP rule plus the head, as the frozen count adds
    it, equals the program's `flops.accounting` at the published sizes:
    23.27 GFLOP a token at S 4,096."""
    from repro_torch.configs.base import ShapeSpec, get_config
    from repro_torch.flops.accounting import forward_flops
    c = harness.load_cell(smoke.ROOT, CELL).sizes
    for B, S in ((2, 4096), (1, 512)):
        want = forward_flops(get_config(ARCH),
                             ShapeSpec("t", S, B, "train")).total_mxu
        assert flops.forward_flops(c, B, S) == pytest.approx(want,
                                                             rel=1e-12)
    assert flops.forward_flops(c, 1, 4096) / 4096 == pytest.approx(
        23_267_590_144, rel=1e-12)


def test_the_cells_file_builds_the_registrys_config():
    cell = harness.load_cell(smoke.ROOT, CELL)
    cfg = harness.model_config(cell)
    harness.check_layout(cfg, cell.sizes)
    assert cfg.shared_block_layers == (6, 11, 17, 23, 29, 35, 41, 47, 53, 59,
                                    65, 71, 77)
    assert (cfg.num_shared_blocks, cfg.adapter_rank, cfg.head_dim) == \
        (2, 128, 224)
    assert cfg.ssm_grouped_norm and cfg.activation == "geglu"
    assert (cell.mix["seq_len"], cell.mix["batch"]) == (4096, 2)
    conf = json.loads((smoke.BENCH / "configs" / f"{ARCH}.json").read_text())
    assert conf["hybrid_layer_ids"] == list(cfg.shared_block_layers)
    assert conf["num_mem_blocks"] == cfg.num_shared_blocks


def test_the_cell_runs_at_smoke_size(tmp_path):
    root = smoke.make_root(tmp_path, {"z.train": (ARCH, smoke.TRAIN_MIX)})
    line = harness.run_cell(root, "z.train", 2**33 + 7, 0.2, True, CPU, 0.0)
    assert line["correct"] is True and line["attempted"] > 0
    assert {"shared_block_ms.train", "mfu.train", "forward_ms.train",
            "recompute_ms.train"} <= set(line["metrics"])
