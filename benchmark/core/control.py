"""The controls: the plain reference put in the program's place with one
guarantee of the configuration broken, the step a faster program would
be tempted by.  A configuration names its control (``"control"``); the
check has to read a control's answers as wrong.

- ``merge_leftmost``: merges the leftmost pair that is a token, not the
  lowest-ranked pair (breaks "lowest rank first").
"""

from __future__ import annotations

from .reference import INF, Reference, merge_loop


def _leftmost(pair):
    for i, r in enumerate(pair):
        if r != INF:
            return i
    return None


class MergeLeftmost(Reference):
    def merge(self, piece: bytes) -> list[int]:
        whole = self.ranks.get(piece)
        if whole is not None:
            return [whole]
        return merge_loop(piece, self.ranks.get, pick=_leftmost)


CONTROLS = {"merge_leftmost": MergeLeftmost}
