"""Prompt-attention syntax (port of imagharmony_tpu/utils/prompts.py): the
community ``(emphasized)`` / ``(word:1.5)`` / ``[de-emphasized]`` weighting
grammar popularized by AUTOMATIC1111's stable-diffusion-webui and compel.

``parse_prompt_attention`` is the published A1111 algorithm (re-derived):
``(x)`` multiplies by 1.1, ``[x]`` by 1/1.1, ``(x:w)`` by w, nesting
multiplies, ``\\(`` escapes a literal bracket. The weights multiply the
text-encoder output embeddings per token, then the embedding mean is
restored (the A1111 application rule), in the conditioning build
(``pipelines/harmony_edit.build_conditioning``).

Opt-in (``generate(..., prompt_weighting=True)``): by default brackets
remain literal characters, as the reference pipeline keeps them.
"""

from __future__ import annotations

import re

_ATTN_RE = re.compile(
    r"""
    \\\(|\\\)|\\\[|\\\]|\\\\|\\:|   # escaped specials -> literal char
    \(|\[|                          # openers
    :\s*([+-]?[\d.]+)\s*\)|         # ":w)" closes a round group at weight w
    \)|\]|                          # plain closers
    [^\\()\[\]:]+|:                 # runs of plain text; stray colon
    """,
    re.X,
)


def parse_prompt_attention(text: str):
    """-> list of [fragment, weight] with adjacent equal weights merged.

    Unbalanced openers apply to the rest of the prompt; unmatched closers
    are literal no-ops (matching the A1111 grammar's forgiving behavior).
    """
    res: list = []
    round_brackets: list = []
    square_brackets: list = []

    def multiply_range(start, mult):
        for i in range(start, len(res)):
            res[i][1] *= mult

    for m in _ATTN_RE.finditer(text or ""):
        tok = m.group(0)
        weight = m.group(1)
        if tok.startswith("\\"):
            res.append([tok[1:], 1.0])
        elif tok == "(":
            round_brackets.append(len(res))
        elif tok == "[":
            square_brackets.append(len(res))
        elif weight is not None:
            if round_brackets:
                multiply_range(round_brackets.pop(), float(weight))
            else:  # ":w)" with no open group: literal text
                res.append([tok, 1.0])
        elif tok == ")":
            if round_brackets:
                multiply_range(round_brackets.pop(), 1.1)
            else:
                res.append([tok, 1.0])
        elif tok == "]":
            if square_brackets:
                multiply_range(square_brackets.pop(), 1.0 / 1.1)
            else:
                res.append([tok, 1.0])
        else:
            res.append([tok, 1.0])

    for pos in round_brackets:
        multiply_range(pos, 1.1)
    for pos in square_brackets:
        multiply_range(pos, 1.0 / 1.1)

    if not res:
        return [["", 1.0]]
    merged = [res[0]]
    for frag, w in res[1:]:
        if w == merged[-1][1]:
            merged[-1][0] += frag
        else:
            merged.append([frag, w])
    return merged


def is_weighted(fragments) -> bool:
    return any(w != 1.0 for _, w in fragments)


def plain_text(fragments) -> str:
    return "".join(frag for frag, _ in fragments)
