"""A cell's pipeline, written in a workload file as the PyTerrier-style
expression a user writes (``(Retrieve("BM25") >> (Extract("QL") **
Extract("TF_IDF"))) % 1000``), parsed into a small tree without ``eval``:
stages (``Retrieve``, ``Extract``, ``DenseRerank``, ``Generate``) with
constant arguments, and the operators ``>>`` (then), ``**`` (feature
union) and ``%`` (cutoff).  The tree builds the program's pipeline and
drives the reference, which evaluates it on sampled queries."""
from __future__ import annotations

import ast
import dataclasses

STAGES = ("Retrieve", "Extract", "DenseRerank", "Generate")
_OPS = {ast.RShift: "then", ast.Pow: "union", ast.Mod: "cutoff"}


@dataclasses.dataclass(frozen=True)
class Node:
    op: str                     # "stage" | "then" | "union" | "cutoff"
    name: str = ""              # stage name
    args: tuple = ()
    kwargs: tuple = ()          # ((key, value), ...)
    children: tuple = ()
    k: int = 0                  # cutoff depth

    def param(self, i: int, key: str, default=None):
        kw = dict(self.kwargs)
        if key in kw:
            return kw[key]
        return self.args[i] if len(self.args) > i else default

    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()

    def stages(self, name: str) -> list:
        return [n for n in self.walk() if n.op == "stage" and n.name == name]


def parse(expr: str) -> Node:
    return _node(ast.parse(expr, mode="eval").body)


def _const(e):
    if isinstance(e, ast.Constant):
        return e.value
    if isinstance(e, ast.UnaryOp) and isinstance(e.op, ast.USub):
        return -_const(e.operand)
    raise ValueError(f"only constants may be stage arguments: {ast.dump(e)}")


def _node(e) -> Node:
    if isinstance(e, ast.BinOp) and type(e.op) in _OPS:
        op = _OPS[type(e.op)]
        if op == "cutoff":
            return Node("cutoff", children=(_node(e.left),),
                        k=int(_const(e.right)))
        return Node(op, children=(_node(e.left), _node(e.right)))
    if isinstance(e, ast.Call) and isinstance(e.func, ast.Name) \
            and e.func.id in STAGES:
        return Node("stage", e.func.id, tuple(_const(a) for a in e.args),
                    tuple((k.arg, _const(k.value)) for k in e.keywords))
    raise ValueError(f"unsupported pipeline expression: {ast.dump(e)}")


def build(node: Node, rt):
    """The program's pipeline for ``node`` (``rt``: the repro_torch
    package)."""
    if node.op == "stage":
        return getattr(rt, node.name)(*node.args, **dict(node.kwargs))
    if node.op == "cutoff":
        return build(node.children[0], rt) % node.k
    a, b = (build(c, rt) for c in node.children)
    return a >> b if node.op == "then" else a ** b

