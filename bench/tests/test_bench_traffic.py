"""The traffic generator: the same seed gives the same stream, and the
backlog parameters are what the mix files state."""

import numpy as np
import pytest

import tiny  # noqa: F401  (puts bench/ and src/ on the path)
from harness import core
from harness.corpus import DOMAINS, MASK, N_SPECIAL
from harness.traffic import Prompts, stamp, token_prompt

BACKLOG = core.load_json(core.BENCH / "traffic" / "backlog-s512.json")


def small(mix, **kw):
    return dict(mix, pool=64, **kw)


def test_mix_files_state_the_issue_parameters():
    assert BACKLOG["outstanding"] == 1024 and BACKLOG["prompt_len"] == 512
    assert BACKLOG["min_confidence"] == 0.0
    assert BACKLOG["flags"] == [{}, {"size": 1.0}, {"size": 8.0},
                                {"recency": 2.0}]
    prefill = core.load_json(core.BENCH / "traffic" / "prefill-2k.json")
    assert prefill["prompt_len"] == 2048
    decode = core.load_json(core.BENCH / "traffic" / "decode-b32.json")
    assert (decode["batch"], decode["prompt_len"],
            decode["decode_tokens"]) == (32, 512, 256)


@pytest.mark.parametrize("vocab", [512, 28996])
def test_same_seed_same_requests(vocab):
    mix = small(BACKLOG)
    a, b = Prompts(mix, vocab, 7), Prompts(mix, vocab, 7)
    c = Prompts(mix, vocab, 8)
    np.testing.assert_array_equal(a.domains, b.domains)
    for uid in (0, 1, 5, 300, 4097):
        ra, rb, rc = a.request(uid), b.request(uid), c.request(uid)
        for x, y in zip(ra[:3], rb[:3]):
            np.testing.assert_array_equal(x, y)
        assert ra[3] == rb[3]
        assert not np.array_equal(ra[0], rc[0])
        assert ra[0].max() < vocab


def test_pool_is_balanced_by_domain_and_flags():
    p = Prompts(dict(BACKLOG, pool=256), 512, 4)
    D, F = len(DOMAINS), len(BACKLOG["flags"])
    assert p.domains.shape == (256,)
    # every aligned block of D x F rows holds each (domain, flags) once
    for b in range(0, 256, D * F):
        pairs = {(int(p.domains[i]), i % F) for i in range(b, b + D * F)}
        assert len(pairs) == D * F
    assert not np.array_equal(p.domains, Prompts(dict(BACKLOG, pool=256),
                                                 512, 5).domains)
    with pytest.raises(ValueError):
        Prompts(dict(BACKLOG, pool=48), 512, 4)


def test_backlog_prompts_are_unique_and_well_formed():
    p = Prompts(small(BACKLOG), 512, 3)
    seen = set()
    for uid in range(2000):
        tokens, targets, mask, lam = p.request(uid)
        assert tokens.dtype == np.int32 and tokens.shape == (512,)
        assert tokens.min() >= MASK and (tokens != 0).all()
        assert mask[0] == 0 and not mask[1:4].any()
        # unmasked positions carry their own target
        np.testing.assert_array_equal(tokens[mask == 0], targets[mask == 0])
        assert lam == BACKLOG["flags"][uid % 4]
        seen.add(tokens.tobytes())
    assert len(seen) == 2000


def test_stamp_round_trips_and_refuses_overflow():
    t = np.zeros(8, np.int32)
    stamp(t, 123456, 3, 512)
    base = 512 - N_SPECIAL
    digits = t[1:4] - N_SPECIAL
    assert int(digits[0] + base * digits[1] + base * base * digits[2]) == 123456
    with pytest.raises(ValueError):
        stamp(t, base ** 3, 3, 512)


def test_token_prompts_are_seeded():
    mix = {"prompt_len": 2048}
    a = token_prompt(mix, 49152, 5, 3)
    np.testing.assert_array_equal(a, token_prompt(mix, 49152, 5, 3))
    assert not np.array_equal(a, token_prompt(mix, 49152, 5, 4))
    assert a.shape == (1, 2048) and a.min() >= 0 and a.max() < 49152
    assert token_prompt(mix, 49152, 5, 0, rows=32).shape == (32, 2048)
