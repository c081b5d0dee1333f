"""Serving cells whose chained stages read different vocabularies, such as
text-to-text: qwen3-0.6b's 151,936 token ids handed to whisper-medium's
51,865.

The engine hands the next stage ``token % vocab``, repeated over its
prompt (``repro_torch.serving.engine._fanin_combine``).  ``serve``'s check
compares each stage-1 input with stage 0's token as it was produced,
which holds only where the two vocabularies are one: with two, every
token past stage 1's vocabulary would count as a hand-off mismatch, and
its query would find no stage-1 call to judge.  A run here is
``serve.run`` judged by ``check`` below, which is ``serve.check`` on the
window with each stage-1 call's rows mapped back to the stage-0 tokens
they were made from: the same numbers under the same limits.
"""
from __future__ import annotations

from collections import defaultdict, deque
from typing import Dict
from unittest import mock

import numpy as np

from perfbench.kinds import serve

_SERVE_CHECK = serve.check


def run(ctx) -> dict:
    """One run of a serving cell (``serve.run``) judged by ``check``."""
    with mock.patch.object(serve, "check", check):
        return serve.run(ctx)


def check(ctx, qs, stats, calls, window, stage_cfgs, seed) -> Dict:
    """``serve.check`` with stage 1's rows read as stage 0's tokens.
    Stage-0 calls are grouped by their tokens modulo stage 1's
    vocabulary, which two calls can share with different tokens; each
    stage-1 call whose first column is such a group's key takes the next
    call of that group, in time order, and has each row shifted by that
    row's difference, so that a row that is not one token repeated stays
    so.  A stage-1 call left without a stage-0 call keeps its rows, and
    counts as a mismatch."""
    vocab1 = stage_cfgs[1]["vocab_size"]
    made_from = defaultdict(deque)
    for _, _, _, out in window[0]:
        made_from[tuple((out % vocab1).tolist())].append(out.astype(np.int64))

    def as_produced(call):
        t0, t1, heads, out = call
        group = made_from.get(tuple(heads[:, 0].tolist()))
        if not group:
            return call
        raw = group.popleft()
        heads = heads.astype(np.int64)
        return t0, t1, heads - heads[:, :1] + raw[:, None], out

    return _SERVE_CHECK(ctx, qs, stats, calls,
                        [window[0], [as_produced(c) for c in window[1]]],
                        stage_cfgs, seed)
