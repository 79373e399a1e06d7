"""Constrained decoding in the port vs the reference, on the CPU.

The port's copies of the validators (``engine/json_constraint.py``,
``engine/gbnf.py``, ``engine/schema_to_gbnf.py``) give the reference's status
(and ``completable``) after every character of the cases of
``tests/test_json_constraint.py``, ``tests/test_gbnf.py`` and
``tests/test_schema_gbnf.py``, and the reference's grammars for its schemas.

Then the port's ``Engine`` against the reference ``Engine`` on json_mode,
GBNF and json_schema requests, greedy and seeded. Both run the tiny model on
the reference's ``init_params(tiny, seed=0)`` with the layers' output
projections (``o``, ``down``) set to ternary zeros: the residual stream is
the token embedding, so both packages compute the same logits up to f32
rounding (the full model's logits part by up to 6e-2 between the packages,
``tests/test_torch_engine.py``, which moves the host's candidate order) and
the constrained tokens, re-selected on the host from those logits, must be
equal token for token.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tests._torch_cpu  # noqa: F401  (one torch thread per worker)
from wrinklefree_tpu.config import BitNetConfig as RefConfig
from wrinklefree_tpu.config import EngineConfig as RefEngineConfig
from wrinklefree_tpu.engine import Engine as RefEngine
from wrinklefree_tpu.engine import SamplingParams as RefSampling
from wrinklefree_tpu.engine import gbnf as ref_gbnf
from wrinklefree_tpu.engine import json_constraint as ref_json
from wrinklefree_tpu.engine import schema_to_gbnf as ref_schema
from wrinklefree_tpu.models.bitnet import fuse_projections as ref_fuse
from wrinklefree_tpu.models.bitnet import init_params as ref_init
from wrinklefree_tpu.ops.ternary_pallas import make_pallas_linear_fused
from wrinklefree_tpu_torch.config import BitNetConfig, EngineConfig
from wrinklefree_tpu_torch.engine import Engine, SamplingParams
from wrinklefree_tpu_torch.engine import gbnf, json_constraint, schema_to_gbnf
from wrinklefree_tpu_torch.weights import params_from_numpy

# -- the validators --------------------------------------------------------

JSON_TEXTS = [
    # tests/test_json_constraint.py: complete objects, valid prefixes, dead texts
    '{}', '{"a": 1}', '{"a": [1, 2, {"b": null}], "c": "x"}', '{"s": "es\\"c \\u00ff"}',
    '{"n": -0.5e+10}', '  {"a": true, "b": false}  ',
    '{', '{"a"', '{"a": ', '{"a": [1,', '{"a": "unterminated', '{"a": 1.2e', '{"a": tru',
    '', '   ', '{"a": -',
    '[1]', '"str"', '1', 'x', '{,}', '{"a" 1}', '{"a": 01}', '{"a": 1,,}', '{"a": 1}}',
    '{"a": .5}', '{"a": +1}', '{"a": 1} x', '{"a": tr0}', '{"a": "\\q"}', '{]',
    '{"k": [1, {"x": "y\\n"}, -2.5e3, true], "z": {}}', '{"a": 12}',
]

AMBIG = 'root ::= "a" root "b" | "a" root "c" | "a"'
GBNF_CASES = [
    # (grammar, text) of tests/test_gbnf.py
    (r'root ::= "a\nb"', "a\nb"), (r'root ::= "\x41B"', "AB"),
    ('root ::= "yes" | "no"', "yes"), ('root ::= "yes" | "no"', "no"),
    ('root ::= "yes" | "no"', "maybe"), ("root ::= [a-cx]", "abcxd"),
    ('root ::= [^0-9]', "q"), ('root ::= [^0-9]', "5"),
    ('root ::= "a"* "b"', "aaab"), ('root ::= "a"* "b"', "c"),
    ('root ::= "a"+ "b"', "b"), ('root ::= "a"+ "b"', "ab"),
    ('root ::= "a"? "b"', "ab"), ('root ::= "a"? "b"', "aab"),
    ('root ::= "a"{2,3}', "aaaa"), ('root ::= ("ab" | "cd")+ "!"', "abcdab!"),
    ('root ::= ("ab" | "cd")+ "!"', "a!"),
    ('\nroot ::= greeting " " name\ngreeting ::= "hi" | "yo"\nname ::= [A-Z] [a-z]+\n',
     "hi Bob"),
    ('\nroot ::= greeting " " name\ngreeting ::= "hi" | "yo"\nname ::= [A-Z] [a-z]+\n',
     "hi bob"),
    ("root ::= [0-9]+", "123"), ('root ::= "ab"', "ab"), ('root ::= "x"?', "x"),
    ('# header\nroot ::= a b  # trailing\na ::= "x"\nb ::= "y"\n', "xy"),
    (AMBIG, "a" * 40),
]
BAD_GRAMMARS = ['root ::= foo', 'a ::= "x"', 'root ::= "x"\nbad  "y"']

OBJ = {"type": "object", "properties": {"name": {"type": "string"}, "age": {"type": "integer"}},
       "required": ["name", "age"]}
SCHEMA_CASES = [
    # (schema, texts) of tests/test_schema_gbnf.py
    ({"type": "string"}, ['"hi"', "42"]), ({"type": "integer"}, ["-7", "1.5"]),
    ({"type": "number"}, ["1.5e3"]), ({"type": "boolean"}, ["true"]),
    ({"type": "null"}, ["null"]),
    ({"enum": ["red", "green", 3]}, ['"red"', "3", '"blue"']),
    ({"const": {"a": 1}}, ['{"a": 1}']),
    ({"anyOf": [{"type": "integer"}, {"type": "null"}]}, ["5", "null", '"x"']),
    ({}, ['{"k": [1, "a", null]}', "17"]),
    (OBJ, ['{"name": "bo", "age": 3}', '{"age": 3, "name": "bo"}', '{"name": "bo"}',
           '{"name": "bo", "age": "x"}']),
    ({"type": "object", "properties": {"a": {"type": "integer"}, "b": {"type": "boolean"}},
      "required": ["a"]}, ['{"a": 1}', '{"a": 1, "b": true}', '{"b": true}']),
    ({"type": "object", "properties": {"x": {"type": "null"}}, "required": []},
     ["{}", '{"x": null}']),
    ({"type": "object", "properties": {"inner": {"type": "object",
                                                 "properties": {"v": {"type": "number"}},
                                                 "required": ["v"]}},
      "required": ["inner"]}, ['{"inner": {"v": 2.5}}', '{"inner": {}}']),
    ({"type": "array", "items": {"type": "integer"}}, ["[]", "[1, 2, 3]", '[1, "a"]']),
    ({"type": "array", "items": {"type": "integer"}, "minItems": 2, "maxItems": 3},
     ["[1]", "[1, 2]", "[1, 2, 3]", "[1, 2, 3, 4]"]),
]


def _trace(make, text):
    """Status (and completable) after each character; a raised GbnfError
    ends the trace with its message."""
    v = make()
    out = [("start", getattr(v, "completable", None))]
    for ch in text:
        try:
            out.append((v.advance(ch), getattr(v, "completable", None)))
        except ValueError as e:
            out.append(("raised", str(e)))
            break
    return out


@pytest.mark.parametrize("text", JSON_TEXTS)
def test_json_validator_equal(text):
    assert (_trace(json_constraint.JsonPrefixValidator, text)
            == _trace(ref_json.JsonPrefixValidator, text))
    # one-shot advance and a clone agree too
    v, r = json_constraint.JsonPrefixValidator(), ref_json.JsonPrefixValidator()
    assert v.advance(text) == r.advance(text)
    assert v.clone().advance("}") == r.clone().advance("}")


@pytest.mark.parametrize("grammar,text", GBNF_CASES)
def test_gbnf_validator_equal(grammar, text):
    assert (_trace(lambda: gbnf.GbnfValidator(grammar), text)
            == _trace(lambda: ref_gbnf.GbnfValidator(grammar), text))
    assert gbnf.parse_gbnf(grammar) == ref_gbnf.parse_gbnf(grammar)


@pytest.mark.parametrize("grammar", BAD_GRAMMARS)
def test_gbnf_parse_errors_equal(grammar):
    with pytest.raises(ref_gbnf.GbnfError) as want:
        ref_gbnf.parse_gbnf(grammar)
    with pytest.raises(gbnf.GbnfError) as got:
        gbnf.parse_gbnf(grammar)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("case", range(len(SCHEMA_CASES)))
def test_schema_to_gbnf_equal(case):
    schema, texts = SCHEMA_CASES[case]
    grammar = schema_to_gbnf.schema_to_gbnf(schema)
    assert grammar == ref_schema.schema_to_gbnf(schema)
    for text in texts:
        assert (_trace(lambda: gbnf.GbnfValidator(grammar), text)
                == _trace(lambda: ref_gbnf.GbnfValidator(grammar), text))


# -- the engines -------------------------------------------------------------

ECFG = dict(max_batch_slots=4, page_size=8, num_pages=64, max_context=64,
            prefill_buckets=(8, 16, 32))
# id i -> chr(i) over printable ASCII (tests/test_json_constraint.py's pieces)
PIECES = [chr(i) if 32 <= i < 127 else "" for i in range(256)]
SCHEMA = {"type": "object", "properties": {"ok": {"type": "boolean"}, "n": {"type": "integer"}},
          "required": ["ok", "n"]}


@pytest.fixture(scope="module")
def weights():
    """The reference's tiny weights with the o and down projections set to
    ternary zeros (code 1 in each 2-bit field: 0x55)."""
    w = jax.tree.map(np.asarray, ref_init(RefConfig.tiny(), seed=0))
    for name in ("o_qw", "down_qw"):
        w["layers"][name] = np.full_like(w["layers"][name], 0x55)
    return w


def _engines(weights, **over):
    e = dict(ECFG, **over)
    cfg, rcfg = BitNetConfig.tiny(), RefConfig.tiny()
    port = Engine(params_from_numpy(weights, cfg, device="cpu"), cfg, EngineConfig(**e),
                  eos_token_id=0, device="cpu")
    ref = RefEngine(ref_fuse(jax.tree.map(jnp.asarray, weights), rcfg), rcfg,
                    RefEngineConfig(kv_layout="layer", **e), eos_token_id=0,
                    linear_fn=make_pallas_linear_fused(interpret=True))
    port.token_pieces = ref.token_pieces = PIECES
    return port, ref


@pytest.fixture(scope="module")
def engines(weights):
    return _engines(weights)


def _run(eng, sp_cls, jobs):
    """Submit (prompt, kwargs) jobs together; their (tokens, finish reason)."""
    reqs = [eng.submit(p, sp_cls(**kw)) for p, kw in jobs]
    while not all(r.finished for r in reqs):
        eng.step()
    return [(r.output_ids, r.finish_reason) for r in reqs]


def _text(ids):
    return "".join(PIECES[t] for t in ids)


CONSTRAINED = {
    "json_greedy": dict(json_mode=True, max_new_tokens=24, ignore_eos=True),
    "json_seeded": dict(json_mode=True, max_new_tokens=24, temperature=1.5, seed=11),
    "json_seeded_topk": dict(json_mode=True, max_new_tokens=24, temperature=2.0, seed=3,
                             top_k=20, top_p=0.9, repetition_penalty=1.2),
    "gbnf_greedy": dict(grammar='root ::= "yes" | "no"', max_new_tokens=8),
    "gbnf_seeded": dict(grammar="root ::= [a-z]+ \"!\"", max_new_tokens=12,
                        temperature=1.5, seed=2),
    "schema_greedy": dict(grammar=ref_schema.schema_to_gbnf(SCHEMA), max_new_tokens=30,
                          ignore_eos=True),
    "schema_seeded": dict(grammar=ref_schema.schema_to_gbnf(SCHEMA), max_new_tokens=30,
                          temperature=1.3, seed=5),
}


@pytest.mark.parametrize("name", list(CONSTRAINED))
def test_constrained_request_matches_reference(engines, name):
    port, ref = engines
    kw = CONSTRAINED[name]
    (got,) = _run(port, SamplingParams, [([1, 5, 9, 2, 7], kw)])
    (want,) = _run(ref, RefSampling, [([1, 5, 9, 2, 7], kw)])
    assert got == want
    ids, why = got
    text = _text(ids)
    if kw.get("json_mode"):
        assert json_constraint.JsonPrefixValidator().advance(text) in ("ok", "complete")
        if why == "stop":
            json.loads(text)
    else:
        v = gbnf.GbnfValidator(kw["grammar"])
        status = v.advance(text)
        assert status == "complete" or (status == "ok" and (why == "length" or v.completable))


def test_mixed_batch_matches_reference(weights):
    """Constrained rows step one token at a time beside unconstrained rows'
    bursts (segregated decode): every row's tokens and the decode step count
    equal the reference's."""
    port, ref = _engines(weights, decode_burst=8)
    jobs = [([1, 5, 9], CONSTRAINED["json_seeded"]),
            ([4, 4, 4], dict(max_new_tokens=20, ignore_eos=True)),
            ([7, 8, 9, 10], dict(max_new_tokens=20, temperature=1.0, seed=9)),
            ([2, 3], CONSTRAINED["gbnf_greedy"])]
    assert _run(port, SamplingParams, jobs) == _run(ref, RefSampling, jobs)
    assert port.stats["decode_steps"] == ref.stats["decode_steps"]
    assert port.stats["decode_tokens"] == ref.stats["decode_tokens"]


def test_ambiguous_grammar_finishes_like_reference(weights):
    """A grammar whose parse stacks explode ends the request (the validator
    raises inside the candidate walk), as in the reference."""
    port, ref = _engines(weights, max_batch_slots=2)
    pieces = ["a" if 32 <= i < 127 else "" for i in range(256)]
    port.token_pieces = ref.token_pieces = pieces
    kw = dict(grammar=AMBIG, max_new_tokens=40, ignore_eos=True)
    assert (_run(port, SamplingParams, [([1, 5, 9], kw)])
            == _run(ref, RefSampling, [([1, 5, 9], kw)]))


@pytest.mark.parametrize("kw,match", [
    (dict(json_mode=True, logprobs_k=2), "logprobs"),
    (dict(grammar='root ::= "x"', mirostat=2), "mirostat"),
    (dict(grammar="root ::= foo"), "undefined"),
    (dict(mirostat=2, logprobs_k=1), "mirostat"),
])
def test_submit_rejects_like_reference(engines, kw, match):
    port, ref = engines
    with pytest.raises(ValueError, match=match):
        ref.submit([1, 2], RefSampling(**kw))
    with pytest.raises(ValueError, match=match):
        port.submit([1, 2], SamplingParams(**kw))


def test_constrained_needs_token_pieces(weights):
    cfg = BitNetConfig.tiny()
    eng = Engine(params_from_numpy(weights, cfg, device="cpu"), cfg, EngineConfig(**ECFG),
                 device="cpu")
    with pytest.raises(ValueError, match="token_pieces"):
        eng.submit([1, 2], SamplingParams(json_mode=True))
