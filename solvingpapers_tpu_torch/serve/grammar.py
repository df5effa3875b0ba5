"""Grammar-constrained decoding: a host-side incremental JSON stepper
(port of `solvingpapers_tpu/serve/grammar.py`).

`response_format: {"type": "json_object"}` requests must emit text that
`json.loads` accepts — guaranteed by construction, not by prompting. The
engine asks this module, once per emitted token, which token ids are
legal next (`JsonStepper.allowed`), packs them into the `(S, sample_cap)`
allow-list that rides the decode block's one packed control transfer,
and `serve.sampling.fused_sample` restricts that slot's draw (or argmax)
to the listed ids — the mask is a tensor operand, so constrained and
unconstrained slots share one decode program.

The stepper is a character-level pushdown automaton over the JSON
grammar (RFC 8259: objects, arrays, strings with escapes, numbers,
literals), simulated token-by-token: a token id is legal iff feeding its
decoded characters one at a time never leaves the grammar. That makes it
tokenizer-agnostic — single-char vocabs step one grammar transition per
token, merge-y BPE tokens are vetted by simulating their whole string
(a token that completes the document mid-way and then keeps writing is
illegal). Vocab-awareness prevents dead ends: a construct is only ever
OPENED if the vocabulary can CLOSE it (no `[` without `]`, no key
string unless `:` and some value are expressible, no `\\` escape
without a legal continuation), so the allowed set is never empty before
the document completes.

Budget-aware closing: `allowed(budget)` additionally drops any token
whose resulting state could not reach a complete document within the
request's remaining token budget (`min_close`, the pushdown's shortest
completion in characters, is a conservative bound on tokens). As the
budget runs out the mask narrows to closing tokens — `"` then `}`/`]`
— so a constrained greedy stream parses even when the model would
happily keep generating. The document completes at or before the
budget; it is never truncated mid-string.

EOS is never in the allowed set: the only legal end of a constrained
stream is a complete document (`done`), where the engine finishes the
request itself (finish reason "stop"). `submit` rejects a grammar
request that also carries an `eos_id` for exactly this reason.
"""

from __future__ import annotations

import numpy as np

_WS = " \t\n\r"
_DIGITS = "0123456789"
_HEX = "0123456789abcdefABCDEF"
# \u escapes are offered only with full hex coverage; everything a string
# needs is expressible without them, so partial-hex vocabs just skip them
_ESC = '"\\/bfnrt'

# container close cost is 1 char each; these per-mode constants are the
# extra chars to finish the CURRENT token before those closers can run
# (computed in min_close below)


class JsonStepper:
    """Incremental JSON validator + legal-next-token oracle.

    `token_strs` maps token id -> decoded string (`None`/empty entries
    are never legal). `top_object=True` (the json_object contract) pins
    the top-level value to an object. `cache` shares the allowed-set
    memo across steppers built over the SAME token table (the front
    door passes one dict per server): entries are keyed by grammar
    state, so every request after the first reads hot states instead of
    re-simulating the vocabulary. Raises ValueError when the vocabulary
    cannot express even the minimal document ``{}``.
    """

    def __init__(self, token_strs, top_object: bool = True, cache=None):
        self.tokens = [t if t else None for t in token_strs]
        self.top_object = top_object
        avail: set[str] = set()
        for t in self.tokens:
            if t:
                avail.update(t)
        self.avail = avail
        if "{" not in avail or "}" not in avail:
            raise ValueError(
                "tokenizer cannot express a JSON object: no token decodes "
                "to '{' / '}' — json_object mode needs a vocabulary that "
                "covers the JSON structural characters"
            )
        self.has_digit = any(d in avail for d in _DIGITS)
        self.has_str = '"' in avail
        self.has_arr = "[" in avail and "]" in avail
        self.lits = tuple(
            w for w in ("true", "false", "null") if set(w) <= avail
        )
        self.has_esc = any(c in avail for c in _ESC)
        self.has_hex = set("0123456789abcdef") <= {c.lower() for c in avail}
        # minimal complete VALUE in chars: one digit beats '""' / '{}'
        self.min_value = 1 if self.has_digit else 2
        # a key/value pair needs ':' plus an expressible value
        self.has_pair = ":" in avail and (
            self.has_digit or self.has_str or self.has_arr or self.lits
        )
        # mutable state ------------------------------------------------
        self.stack: list[str] = []  # 'obj' / 'arr'
        self.mode = "value"
        self.key = False       # current string is an object key
        self.lit_word = ""
        self.lit_pos = 0
        self.num = ""          # 'sign int0 int dot frac e esign exp'
        self.hex_left = 0
        self._allow_cache: dict = {} if cache is None else cache

    # ---------------------------------------------------------- cloning

    def clone(self) -> "JsonStepper":
        c = object.__new__(JsonStepper)
        c.__dict__.update(self.__dict__)
        c.stack = list(self.stack)
        c._allow_cache = {}  # never share: clones mutate state freely
        return c

    # ------------------------------------------------------------ state

    @property
    def done(self) -> bool:
        return self.mode == "done"

    def _sig(self):
        return (self.mode, self.key, self.lit_word, self.lit_pos,
                self.num, self.hex_left, tuple(self.stack))

    @property
    def min_close(self) -> int:
        """Shortest character count to a complete document from here —
        the pushdown's distance-to-accept, used for budget-aware
        closing (one token emits >= 1 char, so this also bounds the
        TOKEN count conservatively)."""
        cl = len(self.stack)  # one closing char per open container
        m = self.mode
        if m == "done":
            return 0
        if m == "value":
            if self.top_object and not self.stack:
                return 2  # the document must be an object: '{' '}'
            return self.min_value + cl
        if m in ("arr_first", "obj_first", "obj_next", "arr_next"):
            return cl  # the container's own closer is already counted
        if m in ("str", "esc", "str_u"):
            tail = 1 + self.min_value if self.key else 0  # ':' + value
            if m == "str":
                return 1 + tail + cl
            if m == "esc":
                return 1 + 1 + tail + cl
            return self.hex_left + 1 + tail + cl
        if m == "obj_key":
            return 2 + 1 + self.min_value + cl  # '""' ':' value
        if m == "colon":
            return 1 + self.min_value + cl
        if m == "lit":
            return len(self.lit_word) - self.lit_pos + cl
        if m == "num":
            return cl if self._num_complete() else 1 + cl
        raise AssertionError(f"unknown mode {m!r}")

    def _num_complete(self) -> bool:
        return self.num in ("int0", "int", "frac", "exp")

    # ----------------------------------------------------- legal chars

    def _value_starts(self) -> str:
        out = ""
        if self.has_str:
            out += '"'
        out += "{"  # always closable (ctor guarantees '}')
        if self.has_arr:
            out += "["
        if self.has_digit:
            out += _DIGITS
            if "-" in self.avail:
                out += "-"
        out += "".join(w[0] for w in self.lits)
        return out

    def _legal(self) -> str:
        """Every character legal next (before budget filtering)."""
        m = self.mode
        if m == "done":
            return ""
        if m == "value":
            if self.top_object and not self.stack:
                return "{"  # json_object: the document IS an object
            return _WS + self._value_starts()
        if m == "arr_first":
            return _WS + self._value_starts() + "]"
        if m == "obj_first":
            return _WS + ('"}' if self.has_pair else "}")
        if m == "obj_key":
            return _WS + '"'
        if m == "colon":
            return _WS + ":"
        if m == "obj_next":
            return _WS + (',}' if self.has_pair else "}")
        if m == "arr_next":
            return _WS + ",]"
        if m == "str":
            out = '"'
            if self.has_esc:
                out += "\\"
            # any non-control char except the two specials is content
            content = "".join(
                c for c in self.avail
                if ord(c) >= 0x20 and c not in '"\\'
            )
            return out + content
        if m == "esc":
            return _ESC + ("u" if self.has_hex else "")
        if m == "str_u":
            return _HEX
        if m == "lit":
            return self.lit_word[self.lit_pos]
        if m == "num":
            n = self.num
            delims = _WS + (",}" if self.stack and self.stack[-1] == "obj"
                            else ",]" if self.stack else "")
            if n == "sign":
                return _DIGITS
            if n == "int0":
                return ".eE" + delims
            if n == "int":
                return _DIGITS + ".eE" + delims
            if n == "dot":
                return _DIGITS
            if n == "frac":
                return _DIGITS + "eE" + delims
            if n == "e":
                return "+-" + _DIGITS
            if n == "esign":
                return _DIGITS
            if n == "exp":
                return _DIGITS + delims
        raise AssertionError(f"unknown mode {m!r}")

    # ---------------------------------------------------------- feeding

    def _end_value(self) -> None:
        """A value just completed: return to the enclosing container's
        separator state, or accept at the top level."""
        if not self.stack:
            self.mode = "done"
        elif self.stack[-1] == "obj":
            self.mode = "obj_next"
        else:
            self.mode = "arr_next"

    def feed(self, ch: str) -> None:
        """Advance by one character; ValueError if `ch` is not legal."""
        if ch not in self._legal():
            raise ValueError(
                f"char {ch!r} is not legal in grammar state "
                f"{self.mode!r} (stack {self.stack})"
            )
        m = self.mode
        if m == "num" and ch in _WS + ",}]":
            # a complete number ends implicitly at its delimiter: close
            # the value, then re-dispatch the delimiter (whitespace is
            # just a separator — consumed, nothing to re-dispatch)
            self._end_value()
            if ch not in _WS:
                self.feed(ch)
            return
        if ch in _WS and m != "str" and m != "esc" and m != "str_u" \
                and m != "lit" and m != "num":
            return  # inter-token whitespace: no state change
        if m in ("value", "arr_first"):
            if m == "arr_first" and ch == "]":
                self.stack.pop()
                self._end_value()
                return
            if m == "arr_first":
                self.mode = "value"  # fall through to value dispatch
            self._start_value(ch)
            return
        if m == "obj_first":
            if ch == "}":
                self.stack.pop()
                self._end_value()
            else:  # '"'
                self.mode = "str"
                self.key = True
            return
        if m == "obj_key":
            self.mode = "str"
            self.key = True
            return
        if m == "colon":
            self.mode = "value"
            return
        if m == "obj_next":
            if ch == "}":
                self.stack.pop()
                self._end_value()
            else:
                self.mode = "obj_key"
            return
        if m == "arr_next":
            if ch == "]":
                self.stack.pop()
                self._end_value()
            else:
                self.mode = "value"
            return
        if m == "str":
            if ch == '"':
                if self.key:
                    self.key = False
                    self.mode = "colon"
                else:
                    self._end_value()
            elif ch == "\\":
                self.mode = "esc"
            return
        if m == "esc":
            if ch == "u":
                self.mode = "str_u"
                self.hex_left = 4
            else:
                self.mode = "str"
            return
        if m == "str_u":
            self.hex_left -= 1
            if self.hex_left == 0:
                self.mode = "str"
            return
        if m == "lit":
            self.lit_pos += 1
            if self.lit_pos == len(self.lit_word):
                self._end_value()
            return
        if m == "num":
            self._feed_num(ch)
            return
        raise AssertionError(f"unreachable mode {m!r}")

    def _start_value(self, ch: str) -> None:
        if ch == "{":
            self.stack.append("obj")
            self.mode = "obj_first"
        elif ch == "[":
            self.stack.append("arr")
            self.mode = "arr_first"
        elif ch == '"':
            self.mode = "str"
            self.key = False
        elif ch == "-":
            self.mode = "num"
            self.num = "sign"
        elif ch in _DIGITS:
            self.mode = "num"
            self.num = "int0" if ch == "0" else "int"
        else:  # literal start (t/f/n) — uniqueness by first char
            self.mode = "lit"
            self.lit_word = next(w for w in self.lits if w[0] == ch)
            self.lit_pos = 1

    def _feed_num(self, ch: str) -> None:
        n = self.num
        if n == "sign":
            self.num = "int0" if ch == "0" else "int"
        elif n in ("int0", "int"):
            if ch == ".":
                self.num = "dot"
            elif ch in "eE":
                self.num = "e"
            else:  # digit; int0 never offers digits so this is int
                self.num = "int"
        elif n == "dot":
            self.num = "frac"
        elif n == "frac":
            self.num = "e" if ch in "eE" else "frac"
        elif n == "e":
            self.num = "esign" if ch in "+-" else "exp"
        elif n in ("esign", "exp"):
            self.num = "exp"

    # --------------------------------------------------------- tokens

    def _token_ok(self, s: str, budget: int | None):
        """(legal, min_close_after) — simulate the whole token string."""
        sim = self.clone()
        try:
            for ch in s:
                sim.feed(ch)
        except ValueError:
            return False, 0
        after = sim.min_close
        if budget is not None and after > budget - 1:
            return False, after
        return True, after

    def allowed(self, budget: int | None = None) -> list[int]:
        """Token ids legal next, most-closing first.

        `budget` is the request's remaining TOKEN budget including the
        next draw; a token is dropped when the state it leads to cannot
        complete the document within the rest (`min_close` chars <=
        budget - 1 tokens — conservative, every token is >= 1 char).
        Ordered by (distance-to-accept after the token, id): when the
        engine truncates the list to `sample_cap`, closing/structural
        tokens survive, so a truncated mask still always completes.
        Deterministic, memoized per grammar state."""
        if self.done:
            return []
        mc = self.min_close
        if budget is not None and budget <= mc:
            # too tight to spend this token on anything but the shortest
            # closing path; mc == budget still works (1 char per token)
            budget = mc
        # the filter depends only on (state, budget - mc): min_close
        # deltas are stack-depth-independent, so collapse the key
        key = (self._sig(),
               None if budget is None else min(budget - mc, 1 << 12))
        hit = self._allow_cache.get(key)
        if hit is not None:
            return hit
        scored = []
        for tid, s in enumerate(self.tokens):
            if not s:
                continue
            ok, after = self._token_ok(s, budget)
            if ok:
                scored.append((after, tid))
        scored.sort()
        out = [tid for _, tid in scored]
        self._allow_cache[key] = out
        return out

    def advance(self, token_id: int) -> None:
        """Consume an emitted token (ValueError if it was never legal —
        the engine only ever feeds ids from `allowed`)."""
        s = self.tokens[token_id]
        if not s:
            raise ValueError(f"token {token_id} decodes to nothing")
        for ch in s:
            self.feed(ch)


def encode_allow(ids, cap: int) -> np.ndarray:
    """Pack an allowed-id list into the engine's fixed-width (cap,)
    int32 allow row (-1 padded; over-long lists keep the head, which
    `JsonStepper.allowed`'s most-closing-first order makes safe)."""
    row = np.full(cap, -1, np.int32)
    n = min(len(ids), cap)
    row[:n] = ids[:n]
    return row
