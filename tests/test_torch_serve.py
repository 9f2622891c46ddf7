"""The port's serving engine (`repro_torch.serve`, device="cpu") against the reference's.

The reference runs once per file in a subprocess (tests/torch_parity.py): it
serves the request sets of tests/test_serve.py with its `Engine` and
`generate_reference` on the smoke configs (f32; dense, the two MoE ones,
whose bucketed prefills route their right-padding too, and the ssm and
hybrid ones, mamba2 and zamba2, which prefill at the exact prompt length
even with bucket_prefill=True: SSM state integrates every token) and
exports its parameters;
the port serves the same requests with the same parameters
(`params_from_reference`) and must give the same tokens and statistics.
Greedy decoding compares argmaxes of logits that agree to ~3e-6
(tests/test_torch_lm.py); sampling draws from the same seeded numpy
generator over probabilities that agree as closely.
"""

import numpy as np
import pytest

from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models.convert import params_from_reference
from repro_torch.serve import Engine, Request, SamplingParams, generate_reference
from torch_parity import run_reference

ARCHS = ("internlm2-1.8b", "codeqwen1.5-7b")
MOE_ARCHS = ("qwen3-moe-235b-a22b", "deepseek-v2-lite-16b")
SSM_ARCHS = ("mamba2-780m", "zamba2-2.7b")
SAMPLED = dict(temperature=0.8, top_k=40)


def _requests(n, vocab, seed=0, max_new=5, sampled=False):
    """tests/test_serve.py's request sets; `sampled` gives every other request
    temperature 0.8 with top-k 40, seeded by its uid."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        plen = int(rng.integers(1, 7))
        sampling = SamplingParams(seed=i, **SAMPLED) if sampled and i % 2 else SamplingParams()
        out.append(Request(uid=i, prompt=rng.integers(0, vocab, plen).tolist(),
                           max_new_tokens=max_new, sampling=sampling))
    return out


def _overflow_requests():
    """Three one-token prompts of 15 new tokens on 2 slots of max_len 16: the
    third runs while the other slot sits idle and its length passes max_len."""
    return [Request(uid=i, prompt=[7 + i], max_new_tokens=15) for i in range(3)]


# (name, arch, engine kwargs, request-set expression); every set is built the
# same way on both sides from the helpers above
ENGINE_CASES = [
    ("oracle_" + arch, arch, dict(max_batch=2, max_len=64), "_requests(5, V)")
    for arch in ARCHS + MOE_ARCHS + SSM_ARCHS
] + [
    ("slot_reuse", ARCHS[0], dict(max_batch=2, max_len=64), "_requests(6, V, max_new=3)"),
    ("bucketed", ARCHS[0], dict(max_batch=2, max_len=64, bucket_prefill=True),
     "_requests(4, V, seed=3)"),
    ("exact", ARCHS[0], dict(max_batch=2, max_len=64, bucket_prefill=False),
     "_requests(4, V, seed=3)"),
    ("temperature", ARCHS[0], dict(max_batch=1, max_len=32),
     "[Request(uid=0, prompt=[1, 2], max_new_tokens=6, "
     "sampling=SamplingParams(temperature=0.8, top_k=10, seed=42))]"),
    ("sampled", ARCHS[0], dict(max_batch=2, max_len=64), "_requests(6, V, seed=4, sampled=True)"),
    ("overflow", ARCHS[0], dict(max_batch=2, max_len=16), "_overflow_requests()"),
    ("slot_reuse_mamba2", SSM_ARCHS[0], dict(max_batch=2, max_len=64),
     "_requests(6, V, max_new=3)"),
    ("exact_mamba2", SSM_ARCHS[0], dict(max_batch=2, max_len=64, bucket_prefill=False),
     "_requests(4, V, seed=3)"),
    ("sampled_zamba2", SSM_ARCHS[1], dict(max_batch=2, max_len=64),
     "_requests(6, V, seed=4, sampled=True)"),
    ("overflow_zamba2", SSM_ARCHS[1], dict(max_batch=2, max_len=16), "_overflow_requests()"),
]
ORACLE = {arch: "_requests(5, V)" for arch in ARCHS + MOE_ARCHS + SSM_ARCHS}


def _helpers_source():
    import inspect
    return (f"SAMPLED = {SAMPLED!r}\n" + inspect.getsource(_requests) + "\n"
            + inspect.getsource(_overflow_requests))


@pytest.fixture(scope="module")
def reference():
    body = f"""
import jax.numpy as jnp
from repro.configs.base import get_smoke_config
from repro.launch import serve as launch_serve
from repro.models.nn import paths_from_tree
from repro.models.registry import init_all
from repro.serve import Engine, Request, SamplingParams, generate_reference
{_helpers_source()}
params = {{}}
for arch in {ARCHS + MOE_ARCHS + SSM_ARCHS!r}:
    cfg = get_smoke_config(arch)
    params[arch], _ = init_all(cfg, seed=0)
    flat = paths_from_tree({{k: v for k, v in params[arch].items() if k != "prefix"}})
    for i, layer in enumerate(params[arch].get("prefix", [])):
        flat.update(paths_from_tree(layer, f"prefix/{{i}}"))
    for path, v in flat.items():
        OUT[arch + "/param/" + path] = np.asarray(v, np.float32)
for name, arch, kw, reqs in {[(n, a, kw, r) for n, a, kw, r in ENGINE_CASES]!r}:
    cfg = get_smoke_config(arch)
    V = cfg.vocab_size
    eng = Engine(cfg, params[arch], **kw)
    for uid, toks in eng.run(eval(reqs)).items():
        OUT[f"{{name}}/{{uid}}"] = np.asarray(toks)
    OUT[name + "/stats"] = np.asarray([eng.steps, eng.prefill_tokens, eng.decode_tokens])
    lengths = {{"ssm": lambda c: c["length"], "hybrid": lambda c: c["sites"]["length"][0]}}.get(
        cfg.family, lambda c: c["blocks"]["length"][0])(eng.cache)
    OUT[name + "/lengths"] = np.asarray(lengths)
for arch, reqs in {ORACLE!r}.items():
    cfg = get_smoke_config(arch)
    V = cfg.vocab_size
    for r in eval(reqs):
        OUT[f"generate_reference_{{arch}}/{{r.uid}}"] = np.asarray(
            generate_reference(cfg, params[arch], r, max_len=64))
cfg = get_smoke_config("internlm2-1.8b")
first = generate_reference(cfg, params["internlm2-1.8b"],
                           Request(uid=0, prompt=[5], max_new_tokens=1), max_len=32)[0]
OUT["eos/first"] = np.asarray(first)
out = Engine(cfg, params["internlm2-1.8b"], max_batch=1, max_len=32).run(
    [Request(uid=1, prompt=[5], max_new_tokens=10, eos_id=first)])
OUT["eos/1"] = np.asarray(out[1])
for uid, toks in launch_serve.main([]).items():
    OUT[f"launch/{{uid}}"] = np.asarray(toks)
for uid, toks in launch_serve.main(["--arch", "mamba2-780m", "--requests", "6"]).items():
    OUT[f"launch_mamba2/{{uid}}"] = np.asarray(toks)
"""
    return run_reference(body)


@pytest.fixture(scope="module")
def params(reference):
    out = {}
    for arch in ARCHS + MOE_ARCHS + SSM_ARCHS:
        pre = arch + "/param/"
        flat = {k[len(pre):]: v for k, v in reference.items() if k.startswith(pre)}
        out[arch] = params_from_reference(get_smoke_config(arch), flat, device="cpu")
    return out


def _ref_tokens(reference, name):
    pre = name + "/"
    return {int(k[len(pre):]): reference[k].tolist() for k in reference
            if k.startswith(pre) and k[len(pre):].isdigit()}


@pytest.mark.parametrize("name,arch,kw,reqs", ENGINE_CASES, ids=[c[0] for c in ENGINE_CASES])
def test_engine_matches_reference(reference, params, name, arch, kw, reqs):
    cfg = get_smoke_config(arch)
    V = cfg.vocab_size  # noqa: F841  (read by the request-set expression)
    eng = Engine(cfg, params[arch], device="cpu", **kw)
    got = eng.run(eval(reqs))
    assert got == _ref_tokens(reference, name)
    assert [eng.steps, eng.prefill_tokens, eng.decode_tokens] == reference[name + "/stats"].tolist()
    # per-slot lengths after the run, idle slots' overgrown ones included
    assert eng.cache["length"].tolist() == reference[name + "/lengths"].tolist()


def test_idle_slot_overflow(reference, params):
    """Idle slots decode too and their lengths outgrow max_len; the cache
    write clamps as JAX's dynamic_update_slice does and nothing raises."""
    cfg = get_smoke_config("internlm2-1.8b")
    eng = Engine(cfg, params["internlm2-1.8b"], max_batch=2, max_len=16, device="cpu")
    out = eng.run(_overflow_requests())
    assert out == _ref_tokens(reference, "overflow")
    assert all(len(t) == 15 for t in out.values())
    assert max(eng.cache["length"].tolist()) == 30 == reference["overflow/lengths"].max()


@pytest.mark.parametrize("arch", ARCHS + MOE_ARCHS + SSM_ARCHS)
def test_generate_reference_matches(reference, params, arch):
    cfg = get_smoke_config(arch)
    V = cfg.vocab_size  # noqa: F841
    for r in eval(ORACLE[arch]):
        got = generate_reference(cfg, params[arch], r, max_len=64, device="cpu")
        assert got == reference[f"generate_reference_{arch}/{r.uid}"].tolist(), r.uid


def test_eos_stops_generation(reference, params):
    cfg = get_smoke_config("internlm2-1.8b")
    p = params["internlm2-1.8b"]
    first = generate_reference(cfg, p, Request(uid=0, prompt=[5], max_new_tokens=1),
                               max_len=32, device="cpu")[0]
    assert first == int(reference["eos/first"])
    out = Engine(cfg, p, max_batch=1, max_len=32, device="cpu").run(
        [Request(uid=1, prompt=[5], max_new_tokens=10, eos_id=first)])
    assert out[1] == [first] == reference["eos/1"].tolist()


def test_launch_serve_matches_reference(reference, params, monkeypatch, capsys):
    """`python -m repro_torch.launch.serve --device cpu` with the reference's
    parameters (its `init_all(cfg, seed=0)`) serves the reference's tokens."""
    monkeypatch.setattr(launch_serve, "init_all",
                        lambda cfg, seed, device: params["internlm2-1.8b"])
    out = launch_serve.main(["--device", "cpu"])
    assert out == _ref_tokens(reference, "launch")
    assert "served 16 requests" in capsys.readouterr().out


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_engine_prefills_at_exact_length(reference, params, arch, monkeypatch):
    """bucket_prefill=True (the default) leaves the ssm and hybrid families at
    the exact prompt length, as the reference does: every prefill takes the
    prompt's first P - 1 tokens, unpadded, into a slot zeroed first, and the
    tokens are the reference's."""
    from repro_torch.serve import engine as engine_mod
    cfg = get_smoke_config(arch)
    V = cfg.vocab_size
    eng = Engine(cfg, params[arch], max_batch=2, max_len=64, device="cpu", bucket_prefill=True)
    assert not eng.bucket_prefill
    seen = []
    prefill = eng.api.prefill

    def recorded(cfg_, params_, batch, cache):
        seen.append((batch["tokens"].shape[1],
                     all(bool((buf == 0).all()) for buf in cache.values())))
        return prefill(cfg_, params_, batch, cache)

    eng.api = eng.api._replace(prefill=recorded)
    reqs = _requests(5, V)
    assert eng.run(reqs) == _ref_tokens(reference, "oracle_" + arch)
    assert seen == [(len(r.prompt) - 1, True) for r in reqs if len(r.prompt) > 1]
    assert engine_mod.SUPPORTED_FAMILIES == ("dense", "moe", "ssm", "hybrid")


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "llava-next-mistral-7b"])
def test_engine_refuses_the_reference_unserved_families(arch):
    """encdec and vlm run through prefill and decode_step only, as in the reference."""
    cfg = get_smoke_config(arch)
    with pytest.raises(ValueError, match="families"):
        Engine(cfg, {}, device="cpu")


def test_launch_serve_mamba2_matches_reference(reference, params, monkeypatch, capsys):
    """`python -m repro_torch.launch.serve --arch mamba2-780m --device cpu`."""
    monkeypatch.setattr(launch_serve, "init_all", lambda cfg, seed, device: params["mamba2-780m"])
    out = launch_serve.main(["--arch", "mamba2-780m", "--requests", "6", "--device", "cpu"])
    assert out == _ref_tokens(reference, "launch_mamba2")
    assert "served 6 requests" in capsys.readouterr().out


def test_engine_rejects_bad_requests(params):
    cfg = get_smoke_config("internlm2-1.8b")
    eng = Engine(cfg, params["internlm2-1.8b"], max_batch=1, max_len=8, device="cpu")
    with pytest.raises(ValueError, match="empty prompt"):
        eng.add_request(Request(uid=0, prompt=[]))
    with pytest.raises(ValueError, match="max_len"):
        eng.add_request(Request(uid=1, prompt=[1, 2], max_new_tokens=7))
