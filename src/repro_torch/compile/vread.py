"""Structural-Verilog netlist reader — the independent RTL check.

The port of `repro.compile.vread`, copied as it is, with its own numpy
decode of the output words in place of the reference's simulator helper.

Parses the subset `repro_torch.compile.verilog` emits (ANSI scalar ports, `wire`
declarations, single-gate `assign` expressions over ~ & | ^ with explicit
parentheses, named-port module instantiations) and re-evaluates the design
bit-parallel in numpy, 64 vectors per uint64 word.  This closes the loop on
the Verilog backend: the emitted RTL is executed by a *separate* evaluator
that never sees the IR, and must reproduce the compiled `CircuitProgram`
bit-for-bit.

The evaluator is deliberately strict rather than general: statements must
appear in dependency order (the emitter's levelized order guarantees it),
every referenced signal must be declared, and mixing binary operators
without parentheses is a parse error.  Anything outside the subset raises
`VerilogError` instead of guessing.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core import circuits as C

_FULL = np.uint64(0xFFFFFFFFFFFFFFFF)

_KEYWORDS = {"module", "endmodule", "input", "output", "wire", "assign"}
_TOKEN_RE = re.compile(
    r"\s+|(?P<comment>//[^\n]*)|(?P<const>1'b[01])"
    r"|(?P<name>[A-Za-z_][A-Za-z0-9_$]*)|(?P<punc>[~&|^();,.=])")


class VerilogError(ValueError):
    pass


def _decode_words(words: np.ndarray) -> np.ndarray:
    """`(n_out, W)` uint64 output words -> `(W*64,)` int64, LSB-first:
    bit k of word w is vector w*64 + k, output port o is bit o."""
    n_out, W = words.shape
    bits = np.unpackbits(np.ascontiguousarray(words, dtype=np.uint64)
                         .view(np.uint8).reshape(n_out, W * 8), axis=-1,
                         bitorder="little")
    out = np.zeros(W * 64, dtype=np.int64)
    for o in range(n_out):
        out |= bits[o].astype(np.int64) << o
    return out


def _tokenize(text: str) -> list[str]:
    toks, pos = [], 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            raise VerilogError(f"bad character at offset {pos}: "
                               f"{text[pos:pos + 20]!r}")
        pos = m.end()
        if m.lastgroup in ("const", "name", "punc"):
            toks.append(m.group())
    return toks


# expression AST: ("const", 0|1) | ("sig", name) | ("not", e) | ("bin", op, l, r)
@dataclass
class VModule:
    name: str
    ports: list[tuple[str, str]]             # (direction, name) in header order
    wires: set[str] = field(default_factory=set)
    stmts: list[tuple] = field(default_factory=list)
    # ("assign", lhs, expr) | ("inst", module, instance, {port: signal})

    @property
    def inputs(self) -> list[str]:
        return [n for d, n in self.ports if d == "input"]

    @property
    def outputs(self) -> list[str]:
        return [n for d, n in self.ports if d == "output"]


class _Parser:
    def __init__(self, toks: list[str]):
        self.toks = toks
        self.i = 0

    def peek(self) -> str | None:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self) -> str:
        if self.i >= len(self.toks):
            raise VerilogError("unexpected end of file")
        self.i += 1
        return self.toks[self.i - 1]

    def expect(self, tok: str) -> None:
        got = self.next()
        if got != tok:
            raise VerilogError(f"expected {tok!r}, got {got!r}")

    def name(self) -> str:
        tok = self.next()
        if tok in _KEYWORDS or not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_$]*", tok):
            raise VerilogError(f"expected identifier, got {tok!r}")
        return tok

    # -- modules -----------------------------------------------------------
    def parse_design(self) -> dict[str, VModule]:
        mods: dict[str, VModule] = {}
        while self.peek() is not None:
            self.expect("module")
            mod = self.parse_module()
            if mod.name in mods:
                raise VerilogError(f"duplicate module {mod.name!r}")
            mods[mod.name] = mod
        return mods

    def parse_module(self) -> VModule:
        name = self.name()
        self.expect("(")
        ports: list[tuple[str, str]] = []
        direction = None
        while True:
            tok = self.peek()
            if tok in ("input", "output"):
                direction = self.next()
                tok = self.peek()
            if direction is None:
                raise VerilogError("port without direction")
            ports.append((direction, self.name()))
            if self.peek() == ",":
                self.next()
                continue
            self.expect(")")
            break
        self.expect(";")
        mod = VModule(name, ports)
        declared = {n for _, n in ports}
        while True:
            tok = self.next()
            if tok == "endmodule":
                return mod
            if tok == "wire":
                while True:
                    w = self.name()
                    if w in declared:
                        raise VerilogError(f"redeclared signal {w!r}")
                    declared.add(w)
                    mod.wires.add(w)
                    if self.peek() == ",":
                        self.next()
                        continue
                    self.expect(";")
                    break
            elif tok == "assign":
                lhs = self.name()
                if lhs not in declared:
                    raise VerilogError(f"assign to undeclared signal {lhs!r}")
                self.expect("=")
                expr = self.parse_expr()
                self.expect(";")
                mod.stmts.append(("assign", lhs, expr))
            elif tok not in _KEYWORDS:  # instantiation: MODULE instance (...)
                inst = self.name()
                self.expect("(")
                conns: dict[str, str] = {}
                while True:
                    self.expect(".")
                    port = self.name()
                    self.expect("(")
                    sig = self.name()
                    self.expect(")")
                    if port in conns:
                        raise VerilogError(f"duplicate port {port!r} on {inst!r}")
                    conns[port] = sig
                    if self.peek() == ",":
                        self.next()
                        continue
                    self.expect(")")
                    break
                self.expect(";")
                mod.stmts.append(("inst", tok, inst, conns))
            else:
                raise VerilogError(f"unexpected token {tok!r} in module body")

    # -- expressions -------------------------------------------------------
    def parse_expr(self) -> tuple:
        node = self.parse_unary()
        op = None
        while self.peek() in ("&", "|", "^"):
            tok = self.next()
            if op is not None and tok != op:
                raise VerilogError("mixed binary operators without parentheses")
            op = tok
            node = ("bin", op, node, self.parse_unary())
        return node

    def parse_unary(self) -> tuple:
        tok = self.peek()
        if tok == "~":
            self.next()
            return ("not", self.parse_unary())
        if tok == "(":
            self.next()
            node = self.parse_expr()
            self.expect(")")
            return node
        if tok in ("1'b0", "1'b1"):
            self.next()
            return ("const", int(tok[-1]))
        return ("sig", self.name())


@dataclass
class VerilogDesign:
    """A parsed design: bit-parallel re-evaluation of emitted RTL."""

    modules: dict[str, VModule]

    @classmethod
    def parse(cls, text: str) -> "VerilogDesign":
        return cls(_Parser(_tokenize(text)).parse_design())

    def module(self, name: str) -> VModule:
        if name not in self.modules:
            raise VerilogError(f"no module {name!r}")
        return self.modules[name]

    def evaluate(self, top: str, inputs: dict[str, np.ndarray]
                 ) -> dict[str, np.ndarray]:
        """Evaluate `top` on packed uint64 word arrays, one per input port.

        Returns {output port: (W,) uint64 words}.  Statements are evaluated
        in file order; reading a signal before it is driven is an error.
        """
        mod = self.module(top)
        env: dict[str, np.ndarray] = {}
        shape = None
        for port in mod.inputs:
            if port not in inputs:
                raise VerilogError(f"missing value for input port {port!r}")
            env[port] = np.asarray(inputs[port], dtype=np.uint64)
            if shape is None:
                shape = env[port].shape
        if shape is None:  # input-less module (constant circuit)
            shape = (1,)

        def read(sig: str) -> np.ndarray:
            if sig not in env:
                raise VerilogError(f"signal {sig!r} read before it is driven "
                                   f"(in {mod.name!r})")
            return env[sig]

        def ev(expr: tuple) -> np.ndarray:
            kind = expr[0]
            if kind == "const":
                return np.full(shape, _FULL if expr[1] else np.uint64(0),
                               dtype=np.uint64)
            if kind == "sig":
                return read(expr[1])
            if kind == "not":
                return ~ev(expr[1])
            _, op, lhs, rhs = expr
            a, b = ev(lhs), ev(rhs)
            return a & b if op == "&" else a | b if op == "|" else a ^ b

        for stmt in mod.stmts:
            if stmt[0] == "assign":
                _, lhs, expr = stmt
                if lhs in env:
                    raise VerilogError(f"signal {lhs!r} driven twice")
                env[lhs] = ev(expr)
            else:
                _, sub_name, inst, conns = stmt
                sub = self.module(sub_name)
                sub_in = {p: read(conns[p]) for p in sub.inputs if p in conns}
                missing = [p for p in sub.inputs if p not in conns]
                if missing:
                    raise VerilogError(f"instance {inst!r} leaves inputs "
                                       f"{missing} unconnected")
                out = self.evaluate(sub_name, sub_in)
                for p in sub.outputs:
                    if p not in conns:
                        continue
                    if conns[p] in env:
                        raise VerilogError(f"signal {conns[p]!r} driven twice")
                    env[conns[p]] = out[p]
        return {p: read(p) for p in mod.outputs}

    def eval_uint(self, top: str, xbits: np.ndarray,
                  input_prefix: str = "x") -> np.ndarray:
        """`(S, n)` 0/1 matrix -> `(S,)` int64 decoded module outputs.

        Input port `<prefix>{i}` takes column i; output ports are decoded
        LSB-first in header order (y0/k0 is bit 0) — the same convention as
        `Netlist.eval_uint`, so results compare directly.
        """
        xbits = np.asarray(xbits)
        S = xbits.shape[0]
        packed = C.pack_vectors(xbits.astype(np.uint8))   # (n, W)
        mod = self.module(top)
        inputs = {}
        for port in mod.inputs:
            if not port.startswith(input_prefix):
                raise VerilogError(f"input port {port!r} lacks prefix "
                                   f"{input_prefix!r}")
            inputs[port] = packed[int(port[len(input_prefix):])]
        out = self.evaluate(top, inputs)
        words = np.stack([out[p] for p in mod.outputs])    # (n_out, W)
        return _decode_words(words)[:S]


def eval_classifier_verilog(text_or_design: str | VerilogDesign,
                            xbits: np.ndarray,
                            top: str = "tnn_classifier") -> np.ndarray:
    """Binarized readings `(S, F)` -> class labels via the emitted RTL."""
    design = (text_or_design if isinstance(text_or_design, VerilogDesign)
              else VerilogDesign.parse(text_or_design))
    return design.eval_uint(top, xbits).astype(np.int32)
