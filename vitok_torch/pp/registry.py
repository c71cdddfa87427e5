"""Preprocessing string DSL (port of ``vitok_tpu/pp/registry.py``).

Pipe-separated op specs such as
``"to_tensor|normalize(minus_one_to_one)|patchify(16, 256)"``; bare
identifiers in arguments act as strings.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Any, Callable, Dict, List, Tuple

from vitok_torch.pp.ops import OPS


@dataclasses.dataclass(frozen=True)
class OpSpec:
    """One parsed op invocation: name plus literal args and kwargs."""

    name: str
    args: Tuple[Any, ...] = ()
    kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def build(self) -> Callable:
        if self.name not in OPS:
            raise KeyError(f"Unknown op: '{self.name}'. Available: {', '.join(sorted(OPS))}")
        return OPS[self.name](*self.args, **self.kwargs)


def _literal(node: ast.AST) -> Any:
    """AST node -> value; bare identifiers become strings, containers recurse."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Tuple):
        return tuple(_literal(e) for e in node.elts)
    if isinstance(node, ast.List):
        return [_literal(e) for e in node.elts]
    return ast.literal_eval(node)


def parse_op_spec(op_str: str) -> OpSpec:
    """Parse ``'name(args)'`` or a bare ``'name'``."""
    text = op_str.strip()
    if not text:
        raise ValueError("Empty op string")
    if "(" not in text:
        if not text.isidentifier():
            raise ValueError(f"Invalid op syntax: '{op_str}'")
        return OpSpec(text)
    head, _, tail = text.partition("(")
    name = head.strip()
    if not name.isidentifier() or not tail.endswith(")"):
        raise ValueError(f"Invalid op syntax: '{op_str}'")
    body = tail[:-1].strip()
    if not body:
        return OpSpec(name)
    try:
        call = ast.parse(f"__op__({body})", mode="eval").body
        args = tuple(_literal(a) for a in call.args)
        kwargs = {kw.arg: _literal(kw.value) for kw in call.keywords}
    except (SyntaxError, ValueError) as exc:
        raise ValueError(f"Invalid arguments in '{op_str}': {exc}") from exc
    return OpSpec(name, args, kwargs)


def parse_op(op_str: str) -> Tuple[str, Tuple[Any, ...], Dict[str, Any]]:
    """Parse one op spec into ``(name, args, kwargs)``."""
    spec = parse_op_spec(op_str)
    return spec.name, spec.args, spec.kwargs


def parse_pipeline(pp_string: str) -> List[OpSpec]:
    """DSL string -> ordered OpSpec list (empty segments are skipped)."""
    if not pp_string or not pp_string.strip():
        return []
    return [parse_op_spec(seg) for seg in pp_string.split("|") if seg.strip()]


def build_transform(pp_string: str) -> Callable:
    """Compose a callable transform from a DSL string."""
    fns = [spec.build() for spec in parse_pipeline(pp_string)]

    def apply_pipeline(x):
        for fn in fns:
            x = fn(x)
        return x

    return apply_pipeline


__all__ = ["build_transform", "parse_op", "parse_op_spec", "parse_pipeline", "OpSpec", "OPS"]
