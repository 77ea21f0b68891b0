"""What decides ``correct``: the window's answers against the plain
reference, exactly.

``Keeper`` holds, for one kind of answer, every answer of the window's
first pass over the pool and ``per_call`` answers of each later call,
drawn from the seed.  ``judge`` compares them with the reference once the
window has closed; an answer missing from a call's output is wrong."""

from __future__ import annotations

import random


class Keeper:
    def __init__(self, seed, kind: str, per_call: int = 8):
        self.rng = random.Random(f"{seed}/sample/{kind}")
        self.per_call = per_call
        self.full: dict = {}      # pool key -> (answers, n sent)
        self.sampled: list = []   # (pool key, index, answer or None)
        self.attempted = 0

    def keep(self, key, answers, n_sent: int) -> None:
        self.attempted += n_sent
        if key not in self.full:
            self.full[key] = (answers, n_sent)
            return
        for j in self.rng.sample(range(n_sent), min(self.per_call, n_sent)):
            self.sampled.append((key, j, answers[j] if j < len(answers)
                                 else None))


def judge(keeper: Keeper, expected) -> tuple[int, int]:
    """(answers compared, answers wrong); ``expected(key, j)`` is the
    reference's answer (computed once each)."""
    memo: dict = {}

    def want(key, j):
        if (key, j) not in memo:
            memo[key, j] = expected(key, j)
        return memo[key, j]

    n = wrong = 0
    for key, (answers, n_sent) in keeper.full.items():
        for j in range(n_sent):
            got = answers[j] if j < len(answers) else None
            n += 1
            wrong += got != want(key, j)
    for key, j, got in keeper.sampled:
        n += 1
        wrong += got != want(key, j)
    return n, wrong
