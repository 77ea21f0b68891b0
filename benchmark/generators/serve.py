"""Generator ``serve``: ``pool_batches`` scheduler steps of an LLM chat
server's tokenizer worker, each the prompts it admits (text, to encode)
and the completions that finished (ids, to decode).

- A prompt's length in UTF-8 bytes is lognormal (``prompt_bytes``:
  median, sigma, clipped to min-max).  A share of the prompts opens with
  one of a few seeded system prompts (``system_prompts``); the rest of
  the prompt is 2-8 turns (``turns``) of Pareto-ranked prose
  (``core/traffic.py``) joined by blank lines, cut to the length.
- A completion is the plain reference's ids of a prose answer of a
  lognormal length (``completion_bytes``), EOS after it; a share
  (``tool_call_share``) opens with the tool-call special and holds a
  JSON-like call in place of prose.
- Every word may be replaced by the mix's ``replace`` rules
  (out-of-vocabulary words); a share of the prompts (``multilingual``)
  also by its word list, which sends a prompt down the UTF-8 route.

The seed draws the whole pool: the shapes (every length, the turns,
which prompts open with a system prompt, which prompts are
multilingual, which completions are tool calls) and the words.  The
same seed gives the same pool."""

from __future__ import annotations

import json
import math
import random

from benchmark.core.traffic import clip_bytes, pareto_word, prose, \
    replace_words

# the fewest bytes of prose asked for at once (``prose`` makes nothing
# under 16)
MIN_PROSE = 32


def lognormal_bytes(rng, spec) -> int:
    n = round(rng.lognormvariate(math.log(spec["median"]), spec["sigma"]))
    return max(spec["min"], min(spec["max"], n))


def text(mix, words, is_token, rng, n_bytes, rules) -> str:
    n = max(MIN_PROSE, n_bytes)
    return replace_words(prose(words, rng, n, mix)[:n], rng, rules,
                         is_token)


def rules_of(mix, shape) -> list:
    """The word rules of one prompt."""
    multi = mix["multilingual"]
    return mix["replace"] + ([multi["rule"]] if shape.random() < multi["p"]
                             else [])


def system_prompts(mix, words, is_token, seed) -> list[str]:
    spec = mix["system_prompts"]
    rng = random.Random(f"{seed}/system")
    per = spec["bytes"] // spec["paragraphs"]
    return [clip_bytes("\n\n".join(
        text(mix, words, is_token, rng, per, mix["replace"])
        for _ in range(spec["paragraphs"])), spec["bytes"])
        for _ in range(spec["count"])]


def prompt(mix, words, is_token, shape, rng, systems) -> str:
    n = lognormal_bytes(shape, mix["prompt_bytes"])
    parts = []
    if shape.random() < mix["system_prompts"]["share"]:
        parts.append(systems[shape.randrange(len(systems))])
    rules = rules_of(mix, shape)
    body = n - sum(len(p.encode("utf-8")) + 2 for p in parts)
    k = shape.randint(*mix["turns"])
    parts += [text(mix, words, is_token, rng, body // k, rules)
              for _ in range(k)]
    return clip_bytes("\n\n".join(parts), n)


def completion(mix, words, ref, shape, rng, cfg) -> list[int]:
    n = lognormal_bytes(shape, mix["completion_bytes"])
    rules = mix["replace"]
    is_token = ref.ranks.__contains__
    ids = []
    if shape.random() < mix["tool_call_share"]:
        name = "_".join(pareto_word(words, rng, mix["pareto_alpha"])
                        for _ in range(2))
        arg = text(mix, words, is_token, rng, n - 48, rules)
        ids.append(cfg["tool_calls_id"])
        body = json.dumps([{"name": name, "arguments": {"query": arg}}],
                          ensure_ascii=False)
    else:
        body = clip_bytes(text(mix, words, is_token, rng, n, rules), n)
    ids += ref.encode(body)
    ids.append(cfg["eos_id"])
    return ids


def pool(mix, words, ref, seed, cfg) -> list[dict]:
    """``pool_batches`` steps: {"prompts": texts, "completions": id
    lists}, ``batch_docs`` prompts and ``batch_completions`` completions
    a step."""
    is_token = ref.ranks.__contains__
    systems = system_prompts(mix, words, is_token, seed)
    out = []
    for b in range(mix["pool_batches"]):
        shape = random.Random(f"{seed}/serve-shape/{b}")
        rng = random.Random(f"{seed}/step/{b}")
        out.append({
            "prompts": [prompt(mix, words, is_token, shape, rng, systems)
                        for _ in range(cfg["batch_docs"])],
            "completions": [completion(mix, words, ref, shape, rng, cfg)
                            for _ in range(cfg["batch_completions"])]})
    return out
