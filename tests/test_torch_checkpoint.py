"""The port's checkpoint loading (models/checkpoint.py) against the JAX
package's, on HF-layout directories each test writes itself from a
seeded numpy generator (2 layers, dim 64, vocab 256).  Loaded trees must
equal the JAX loader's bit for bit, after models/convert.py carries the
JAX tree over; npz files must cross between the packages both ways; an
engine built on a directory must give the JAX engine's greedy tokens.
Tolerances: trees bitwise; the forward of a loaded tree against the
hand-assembled one 1e-5 (fp32, same arithmetic, same inputs)."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax

from ant_ray_tpu.llm import LLMEngine as JaxEngine
from ant_ray_tpu.llm import SamplingParams as JaxSampling
from ant_ray_tpu.llm.tokenizer import ByteTokenizer as JaxByteTokenizer
from ant_ray_tpu.models import checkpoint as jckpt
from ant_ray_tpu_torch.llm import ByteTokenizer, LLMEngine, SamplingParams
from ant_ray_tpu_torch.llm import engine as engine_mod
from ant_ray_tpu_torch.models import checkpoint as ckpt
from ant_ray_tpu_torch.models import llama as tl
from ant_ray_tpu_torch.models.convert import params_from_jax_numpy

torch.backends.cuda.matmul.allow_tf32 = False

DIMS = {"vocab_size": 256, "hidden_size": 64, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2,
        "intermediate_size": 128, "max_position_embeddings": 256,
        "rope_theta": 500000.0, "rms_norm_eps": 1e-5}
HEAD_DIM = DIMS["hidden_size"] // DIMS["num_attention_heads"]
# 3, 40 and 100 tokens: buckets 16, 64 and 128.
PROMPTS = [list(np.random.default_rng(n).integers(0, 250, n))
           for n in (3, 40, 100)]


def _hf_state(seed, tie=False):
    """A HF-layout state dict of fp32 numpy arrays, (out, in) weights
    scaled by 1/sqrt(in)."""
    rng = np.random.default_rng(seed)
    d, f, v = (DIMS["hidden_size"], DIMS["intermediate_size"],
               DIMS["vocab_size"])
    q, kv = (DIMS["num_attention_heads"] * HEAD_DIM,
             DIMS["num_key_value_heads"] * HEAD_DIM)

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-1])).astype(
            np.float32)

    def norm():
        return (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)

    state = {"model.embed_tokens.weight": w(v, d),
             "model.norm.weight": norm()}
    if not tie:
        state["lm_head.weight"] = w(v, d)
    for i in range(DIMS["num_hidden_layers"]):
        p = f"model.layers.{i}."
        state.update({
            p + "input_layernorm.weight": norm(),
            p + "self_attn.q_proj.weight": w(q, d),
            p + "self_attn.k_proj.weight": w(kv, d),
            p + "self_attn.v_proj.weight": w(kv, d),
            p + "self_attn.o_proj.weight": w(d, q),
            p + "post_attention_layernorm.weight": norm(),
            p + "mlp.gate_proj.weight": w(f, d),
            p + "mlp.up_proj.weight": w(f, d),
            p + "mlp.down_proj.weight": w(d, f),
            # ignored by both loaders, as in real checkpoints
            p + "self_attn.rotary_emb.inv_freq": np.ones(HEAD_DIM // 2,
                                                         np.float32),
        })
    return state


def _expected(state, tie=False):
    """The port's tree assembled by hand from an fp32 HF state."""
    layers = {}
    for ours, (hf, transpose) in {
            "ln_attn": ("input_layernorm", False),
            "wq": ("self_attn.q_proj", True),
            "wk": ("self_attn.k_proj", True),
            "wv": ("self_attn.v_proj", True),
            "wo": ("self_attn.o_proj", True),
            "ln_mlp": ("post_attention_layernorm", False),
            "w_gate": ("mlp.gate_proj", True),
            "w_up": ("mlp.up_proj", True),
            "w_down": ("mlp.down_proj", True)}.items():
        stack = [state[f"model.layers.{i}.{hf}.weight"]
                 for i in range(DIMS["num_hidden_layers"])]
        layers[ours] = torch.from_numpy(
            np.stack([a.T if transpose else a for a in stack]).copy())
    tree = {"embed": torch.from_numpy(state["model.embed_tokens.weight"]),
            "norm_f": torch.from_numpy(state["model.norm.weight"]),
            "layers": layers}
    if not tie:
        head = state.get("lm_head.weight", state["model.embed_tokens.weight"])
        tree["lm_head"] = torch.from_numpy(head.T.copy())
    return tree


def _write_config(path, torch_dtype="float32", **extra):
    (path / "config.json").write_text(json.dumps(
        {**DIMS, "torch_dtype": torch_dtype, **extra}))


def _torch_state(state, dtype):
    return {k: torch.from_numpy(v).to(dtype) for k, v in state.items()}


def _write(path, state, fmt):
    """Write ``state`` in one of the formats the loaders read."""
    if fmt == "st_f32":
        from safetensors.numpy import save_file
        save_file(state, str(path / "model.safetensors"))
    elif fmt == "st_f16":
        from safetensors.numpy import save_file
        save_file({k: v.astype(np.float16) for k, v in state.items()},
                  str(path / "model.safetensors"))
    elif fmt == "st_bf16":
        from safetensors.torch import save_file
        save_file(_torch_state(state, torch.bfloat16),
                  str(path / "model.safetensors"))
    elif fmt == "st_two_shards":
        from safetensors.torch import save_file
        names = sorted(state)
        half = len(names) // 2
        for i, part in enumerate((names[:half], names[half:])):
            save_file({k: torch.from_numpy(state[k]) for k in part},
                      str(path / f"model-0000{i + 1}-of-00002.safetensors"))
    elif fmt in ("bin_f32", "bin_bf16"):
        dtype = torch.float32 if fmt == "bin_f32" else torch.bfloat16
        torch.save(_torch_state(state, dtype),
                   str(path / "pytorch_model.bin"))
    else:
        raise ValueError(fmt)


def _bits(t):
    """A tensor's bits, for bitwise comparison."""
    return t.contiguous().view({2: torch.int16, 4: torch.int32}[
        t.element_size()])


def _assert_bitwise(got, want, path=""):
    assert set(got) == set(want), path
    for key, value in want.items():
        if isinstance(value, dict):
            _assert_bitwise(got[key], value, f"{path}{key}.")
        else:
            assert got[key].dtype == value.dtype, f"{path}{key}"
            assert got[key].shape == value.shape, f"{path}{key}"
            assert torch.equal(_bits(got[key]), _bits(value)), f"{path}{key}"


def _from_jax(tree, config):
    return params_from_jax_numpy(jax.tree.map(np.asarray, tree), config,
                                 device="cpu")


@pytest.mark.parametrize("fmt,torch_dtype,tie,keep_head", [
    ("st_f32", "float32", False, True),
    ("bin_f32", "float32", False, True),
    ("bin_bf16", "bfloat16", False, True),
    ("st_f16", "float16", False, True),
    ("st_f32", "float32", True, False),      # tied: no lm_head leaf
    ("st_f32", "float32", False, False),     # lm_head omitted, flag unset
    ("st_two_shards", "float32", False, True),
])
def test_loaded_tree_equals_the_jax_loaders(tmp_path, fmt, torch_dtype, tie,
                                            keep_head):
    state = _hf_state(1, tie=tie)
    if not keep_head:
        state.pop("lm_head.weight", None)
    _write_config(tmp_path, torch_dtype, tie_word_embeddings=tie)
    _write(tmp_path, state, fmt)
    params, config = ckpt.load_llama_params(str(tmp_path), device="cpu")
    jparams, _ = jckpt.load_llama_params(str(tmp_path))
    want_dtype = torch.float32 if torch_dtype == "float32" else torch.bfloat16
    assert config.dtype == want_dtype and config.tie_embeddings == tie
    assert "lm_head" not in params if tie else "lm_head" in params
    _assert_bitwise(params, _from_jax(jparams, config))
    if torch_dtype == "float32":
        _assert_bitwise(params, _expected(state, tie=tie))


def test_bf16_safetensors_equal_the_jax_load_of_the_same_bin(tmp_path):
    """bf16 .safetensors is the format Llama-3 ships in.  The reference
    reads it through numpy, which knows bf16 only because importing JAX
    registers ml_dtypes' type; the port reads it itself.  Its load must
    equal the reference's of the same file and of the same tensors
    written as a bf16 .bin."""
    state = _hf_state(2)
    st_dir, bin_dir = tmp_path / "st", tmp_path / "bin"
    for d, fmt in ((st_dir, "st_bf16"), (bin_dir, "bin_bf16")):
        d.mkdir()
        _write_config(d, "bfloat16")
        _write(d, state, fmt)
    params, config = ckpt.load_llama_params(str(st_dir), device="cpu")
    for d in (st_dir, bin_dir):
        jparams, _ = jckpt.load_llama_params(str(d))
        _assert_bitwise(params, _from_jax(jparams, config))
    _assert_bitwise(params, ckpt.load_llama_params(str(bin_dir),
                                                   device="cpu")[0])


def test_reader_yields_stored_dtypes_and_equals_the_library(tmp_path):
    from safetensors.torch import load_file, save_file

    rng = np.random.default_rng(3)
    tensors = {"a": torch.from_numpy(rng.standard_normal((3, 5))).float(),
               "b": torch.from_numpy(rng.standard_normal(7)).to(
                   torch.bfloat16),
               "c": torch.from_numpy(rng.standard_normal((2, 2, 3))).half(),
               "empty": torch.zeros((0, 4))}
    path = str(tmp_path / "x.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    got = dict(ckpt.read_safetensors(path))
    want = load_file(path)
    assert set(got) == set(want)
    for name, t in want.items():
        assert got[name].dtype == t.dtype and torch.equal(got[name], t)


def test_loaded_tree_runs_the_hand_assembled_forward(tmp_path):
    """Forward equivalence proves every transpose (as the reference's
    test_load_safetensors does)."""
    state = _hf_state(4)
    _write_config(tmp_path)
    _write(tmp_path, state, "st_f32")
    params, config = ckpt.load_llama_params(str(tmp_path), device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, DIMS["vocab_size"], (1, 16)))
    with torch.inference_mode():
        got = tl.forward(params, tokens, config)
        want = tl.forward(_expected(state), tokens, config)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def _raised(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


def test_errors_match_the_reference(tmp_path):
    state = _hf_state(5)
    del state["model.layers.1.mlp.up_proj.weight"]
    _write_config(tmp_path)
    _write(tmp_path, state, "st_f32")
    msg = _raised(lambda: ckpt.load_llama_params(str(tmp_path),
                                                 device="cpu"))
    assert "missing layer tensors" in msg
    assert msg == _raised(lambda: jckpt.load_llama_params(str(tmp_path)))

    # Same tensor shapes, another head split: a loud error, not a
    # silently scrambled attention.
    config = ckpt.config_from_hf(str(tmp_path))
    other = dataclasses.replace(config, n_heads=2, n_kv_heads=1)
    jother = dataclasses.replace(jckpt.config_from_hf(str(tmp_path)),
                                 n_heads=2, n_kv_heads=1)
    params = tl.init_params(config, device="cpu",
                            generator=torch.Generator().manual_seed(0))
    ckpt.save_params(params, str(tmp_path / "p.npz"), config=config)
    msg = _raised(lambda: ckpt.load_params(str(tmp_path / "p.npz"), other,
                                           device="cpu"))
    assert "head split" in msg
    assert msg == _raised(lambda: jckpt.load_params(str(tmp_path / "p.npz"),
                                                    jother))


def test_reader_takes_a_tensor_at_an_unaligned_offset(tmp_path):
    """A writer need not align buffers to their element size: an F32
    tensor two bytes into the data still reads right."""
    a = torch.tensor([1.5], dtype=torch.bfloat16)
    b = torch.tensor([0.25, -3.0, 7.125])
    header = json.dumps({
        "a": {"dtype": "BF16", "shape": [1], "data_offsets": [0, 2]},
        "b": {"dtype": "F32", "shape": [3], "data_offsets": [2, 14]},
    }).encode()
    header += b" " * (-len(header) % 8)
    path = tmp_path / "odd.safetensors"
    path.write_bytes(len(header).to_bytes(8, "little") + header
                     + a.view(torch.uint8).numpy().tobytes()
                     + b.view(torch.uint8).numpy().tobytes())
    got = dict(ckpt.read_safetensors(str(path)))
    assert torch.equal(got["a"], a) and torch.equal(got["b"], b)


def test_reader_refuses_an_unsupported_dtype(tmp_path):
    from safetensors.numpy import save_file

    path = str(tmp_path / "model.safetensors")
    save_file({"ids": np.arange(4, dtype=np.int64)}, path)
    with pytest.raises(ValueError, match="dtype I64"):
        list(ckpt.read_safetensors(path))


def test_unknown_model_raises_the_references_value_error():
    port = _raised(lambda: LLMEngine("/no/such/checkpoint", device="cpu"))
    assert port == _raised(lambda: JaxEngine("/no/such/checkpoint"))


@pytest.mark.parametrize("model,load,want", [
    ("tiny", True, (False, False)),
    ("tiny", False, (False, False)),
    ("dir", True, (True, True)),
    ("dir", False, (False, True)),
], ids=["named", "named_no_load", "directory", "directory_no_load"])
def test_resolve_model_reads_each_kind_of_model_string(tmp_path, model, load,
                                                       want):
    """(params loaded?, is a directory?) for each kind of string; a
    directory's config is read from config.json whether or not its
    weights are loaded.  Strings of neither kind raise the reference's
    ValueError either way."""
    _write_config(tmp_path)
    _write(tmp_path, _hf_state(9), "st_f32")
    name = str(tmp_path) if model == "dir" else model
    params, config, is_dir = ckpt.resolve_model(name, "cpu", load=load)
    assert (params is not None, is_dir) == want
    assert config == (ckpt.config_from_hf(name) if is_dir
                      else tl.CONFIGS[name])
    if params is not None:
        _assert_bitwise(params, ckpt.load_llama_params(name, device="cpu")[0])
    with pytest.raises(ValueError, match="neither a named config"):
        ckpt.resolve_model(str(tmp_path / "absent"), "cpu", load=load)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_hf_export_loads_back_bit_for_bit(tmp_path, fmt, dtype):
    """hf_state_dict and hf_config, the inverse of the loader's name
    table, written with the safetensors library or torch.save: the loader
    gives back the same config and every leaf's bits, and the library
    reads the state the port wrote."""
    config = dataclasses.replace(
        tl.CONFIGS["tiny"], vocab_size=256, dim=64, n_layers=2, n_heads=4,
        n_kv_heads=2, mlp_dim=128, max_seq=256, dtype=dtype)
    params = tl.init_params(config, generator=torch.Generator().manual_seed(5),
                            device="cpu")
    state = ckpt.hf_state_dict(params)
    assert all(t.is_contiguous() and t.dtype == dtype for t in state.values())
    assert state["model.layers.1.self_attn.q_proj.weight"].data_ptr() != \
        params["layers"]["wq"][1].data_ptr()
    (tmp_path / "config.json").write_text(json.dumps(ckpt.hf_config(config)))
    if fmt == "safetensors":
        from safetensors.torch import load_file, save_file
        save_file(state, str(tmp_path / "model.safetensors"))
        library = load_file(str(tmp_path / "model.safetensors"))
        assert all(torch.equal(_bits(library[k]), _bits(v))
                   for k, v in state.items())
    else:
        torch.save(state, str(tmp_path / "pytorch_model.bin"))
    loaded, got = ckpt.load_llama_params(str(tmp_path), device="cpu")
    assert got == config
    _assert_bitwise(loaded, params)


@pytest.mark.parametrize("torch_dtype", ["float32", "bfloat16"])
def test_npz_crosses_between_the_packages(tmp_path, torch_dtype):
    """JAX save_params → port load_params, and port save_params → JAX
    load_params, bit for bit.  The reference writes a bf16 leaf as 2-byte
    raw (numpy reads it back as |V2); the port writes the same layout and
    reads such a leaf as bf16 bits under a bf16 config."""
    _write_config(tmp_path, torch_dtype)
    _write(tmp_path, _hf_state(6), "bin_f32")
    jparams, jconfig = jckpt.load_llama_params(str(tmp_path))
    config = ckpt.config_from_hf(str(tmp_path))
    want = _from_jax(jparams, config)

    jax_file, port_file = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jckpt.save_params(jparams, jax_file, config=jconfig)
    _assert_bitwise(ckpt.load_params(jax_file, config, device="cpu"), want)

    ckpt.save_params(want, port_file, config=config)
    _assert_bitwise(ckpt.load_params(port_file, config, device="cpu"), want)
    theirs = jckpt.load_params(jax_file, jconfig)
    ours = jckpt.load_params(port_file, jconfig)
    for a, b in zip(jax.tree.leaves(theirs), jax.tree.leaves(ours)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_bf16_npz_leaf_needs_a_bf16_config(tmp_path):
    _write_config(tmp_path, "bfloat16")
    _write(tmp_path, _hf_state(7), "bin_bf16")
    params, config = ckpt.load_llama_params(str(tmp_path), device="cpu")
    ckpt.save_params(params, str(tmp_path / "p.npz"))
    fp32 = dataclasses.replace(config, dtype=torch.float32)
    with pytest.raises(ValueError, match="bf16"):
        ckpt.load_params(str(tmp_path / "p.npz"), fp32, device="cpu")


@pytest.fixture(scope="module")
def fp32_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("llama")
    _write_config(path)
    _write(path, _hf_state(8), "st_f32")
    return str(path)


@pytest.mark.parametrize("chunk", [None, 16])
def test_engine_on_a_directory_gives_the_jax_engines_tokens(fp32_dir, chunk):
    sampling = dict(max_tokens=10)
    jax_out = JaxEngine(fp32_dir, slots=2, tokenizer=JaxByteTokenizer(),
                        prefill_chunk_tokens=chunk).generate(
        PROMPTS, JaxSampling(**sampling))
    engine = LLMEngine(fp32_dir, slots=2, tokenizer=ByteTokenizer(),
                       prefill_chunk_tokens=chunk, device="cpu")
    outs = engine.generate(PROMPTS, SamplingParams(**sampling))
    assert ([(o.token_ids, o.finish_reason) for o in outs]
            == [(o.token_ids, o.finish_reason) for o in jax_out])
    assert engine.config.max_seq == DIMS["max_position_embeddings"]


def test_engine_reads_only_the_config_when_params_are_given(tmp_path,
                                                            fp32_dir):
    """With params given, a directory that holds only config.json is
    enough: no weight file is read."""
    _write_config(tmp_path)
    params, _ = ckpt.load_llama_params(fp32_dir, device="cpu")
    engine = LLMEngine(str(tmp_path), params, slots=1, device="cpu",
                       tokenizer=ByteTokenizer())
    want = LLMEngine(fp32_dir, slots=1, device="cpu",
                     tokenizer=ByteTokenizer())
    prompt, sampling = PROMPTS[1], SamplingParams(max_tokens=6)
    assert (engine.generate([prompt], sampling)[0].token_ids
            == want.generate([prompt], sampling)[0].token_ids)


def test_engine_asks_for_the_directorys_tokenizer(monkeypatch, fp32_dir):
    asked = []

    def get_tokenizer(name):
        asked.append(name)
        return ByteTokenizer()

    monkeypatch.setattr(engine_mod, "get_tokenizer", get_tokenizer)
    LLMEngine(fp32_dir, slots=1, device="cpu")
    LLMEngine("tiny", slots=1, device="cpu")
    assert asked == [fp32_dir, None]
