"""The port's engine on the recurrent layouts against the JAX engine,
token for token: RWKV-6 and the RG-LRU hybrid (reduced, window 16), in
mixed and alternate modes (RWKV-6 also in the eager pin, whose JAX side
compiles one program a suffix length), on a prompt, its repeat, a
continued conversation (turn 2 extends turn 1 and its output) and its
repeat, and the same prompt on another adapter. The snapshot hits and the
``state_hit_rate`` (> 0) must be the reference's. The engines and their
fake clock are those of ``tests/test_torch_state_cache.py``.

    PYTHONPATH=src python -m pytest -q tests/test_torch_state_engine.py
"""

import itertools

import pytest

from repro.serving import Request as JaxRequest
from repro_torch.serving import Request

from test_torch_state_cache import ARCHS, engines


def converse(eng, make):
    """A prompt, its repeat beside a continued conversation (turn 2 extends
    turn 1 and its output), then the repeat of turn 2 and the same prompt
    on the other adapter. Returns (tokens, matched tokens, state hit rate)."""
    ids = itertools.count()

    def req(adapter, prompt, n=4):
        return make(f"st{next(ids)}", adapter, tuple(prompt), max_new_tokens=n)

    turn1 = req("lora-0", range(30, 55))
    eng.submit(turn1)
    eng.run()
    again = req("lora-0", turn1.prompt)
    turn2 = req("lora-0", turn1.full_tokens + tuple(range(200, 206)))
    eng.submit(again)
    eng.submit(turn2)
    eng.run()
    repeat2 = req("lora-0", turn2.prompt, n=3)
    other = req("lora-1", turn2.prompt, n=3)  # another adapter: no hit
    eng.submit(repeat2)
    eng.submit(other)
    report = eng.run()
    reqs = (turn1, again, turn2, repeat2, other)
    return ([tuple(r.generated) for r in reqs], [r.matched_tokens for r in reqs],
            report.state_hit_rate)


@pytest.mark.parametrize("arch,engine_kw", [
    (arch, kw) for arch in ARCHS
    for kw in (dict(schedule_mode="mixed"), dict(schedule_mode="alternate"))
] + [("rwkv6-1.6b", dict(schedule_mode="alternate", prefill_mode="eager"))],
    ids=lambda v: v if isinstance(v, str) else "-".join(map(str, v.values())))
def test_engine_tokens_identical_to_jax(arch, engine_kw):
    jeng, teng = engines(arch, **engine_kw)
    want = converse(jeng, JaxRequest)
    got = converse(teng, Request)
    assert got == want
    tokens, matched, hit_rate = got
    assert matched[0] == 0 and matched[1] == 24  # the repeat resumes at 24 of 25
    assert matched[2] == 24  # turn 2 resumes from turn 1's boundary
    assert matched[3] == 34  # the repeat of turn 2 from turn 2's own
    assert matched[4] == 0  # snapshots belong to their adapter
    assert tokens[1] == tokens[0]
    assert hit_rate > 0
    teng.manager.check_invariants()
