"""The building blocks of the traffic generators
(``generators/<name>.py``): Pareto-ranked prose with numbers,
punctuation and optional features (a frozen copy of the port's
``models.bench.build_corpus``), and per-word replacements by
out-of-vocabulary words (``chip_smoke.py``'s ``oov_word``) or by words
drawn from a list (its ``route3_batch``)."""

from __future__ import annotations


def pareto_word(words, rng, alpha):
    return words[min(int(rng.paretovariate(alpha)) - 1, len(words) - 1)]


def oov_word(rng, is_token, lo, hi):
    """A lowercase word whose space-prefixed and bare forms are not
    tokens."""
    while True:
        w = "".join(rng.choice("abcdefghijklmnopqrstuvwxyz")
                    for _ in range(rng.randint(lo, hi)))
        if not is_token((" " + w).encode()) and not is_token(w.encode()):
            return w


def clip_bytes(text: str, n: int) -> str:
    return text.encode("utf-8")[:n].decode("utf-8", "ignore")


def prose(words, rng, n_bytes, mix):
    """Words joined by spaces up to about ``n_bytes``: Pareto ranks,
    numbers, punctuation and the mix's optional features (a second space
    or a long number after a word, a line break)."""
    alpha = mix["pareto_alpha"]
    num_p, num_max = mix["number_rate"], mix["number_max"]
    punct_p, punct = mix["punct_rate"], mix["punct"]
    extra = mix.get("features", {})
    double_p = extra.get("double_space_rate", 0.0)
    long_num_p = extra.get("long_number_rate", 0.0)
    lo_d, hi_d = extra.get("long_number_digits", [4, 7])
    nl_p = extra.get("newline_rate", 0.0)
    parts, size = [], 0
    while size < n_bytes - 16:
        w = pareto_word(words, rng, alpha)
        parts.append(w)
        size += len(w) + 1
        if rng.random() < num_p:
            parts.append(str(rng.randint(0, num_max)))
            size += 4
        if rng.random() < punct_p:
            parts[-1] += rng.choice(punct)
        x = rng.random()
        if x < double_p:
            parts[-1] += " "
        elif x < double_p + long_num_p:
            d = rng.randint(lo_d, hi_d)
            parts.append(str(rng.randint(10 ** (d - 1), 10 ** d - 1)))
            size += d + 1
        if rng.random() < nl_p:
            parts[-1] += "\n"
    return " ".join(parts)


def replacement(rule, rng, is_token):
    """A word drawn by ``rule``: an out-of-vocabulary word of
    ``oov_letters`` letters, or one of ``choose``."""
    if "oov_letters" in rule:
        return oov_word(rng, is_token, *rule["oov_letters"])
    return rng.choice(rule["choose"])


def replace_words(text, rng, rules, is_token):
    """Per word, the first rule whose cumulative probability covers a
    uniform draw replaces it."""
    if not rules:
        return text
    ws = text.split(" ")
    for i in range(len(ws)):
        x = rng.random()
        acc = 0.0
        for rule in rules:
            acc += rule["p"]
            if x < acc:
                ws[i] = replacement(rule, rng, is_token)
                break
    return " ".join(ws)


def replace_in_doc(text, rng, rules, is_token):
    """Per doc, the first rule whose cumulative probability covers a
    uniform draw replaces ``words`` of its words, chosen at random."""
    x = rng.random()
    acc = 0.0
    for rule in rules:
        acc += rule["p"]
        if x < acc:
            ws = text.split(" ")
            for i in rng.sample(range(len(ws)), min(rule["words"], len(ws))):
                ws[i] = replacement(rule, rng, is_token)
            return " ".join(ws)
    return text
