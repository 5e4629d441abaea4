"""Placement constraint language: parse + node matching.

Reference: manager/constraint/constraint.go (Parse, NodeMatches) — the
`node.id==abc`, `node.labels.foo!=bar`, `engine.labels.x==y` expressions from
service placement specs.  Values match exact or glob (*) like the reference's
use of filepath.Match-style patterns.

The port's own copy of the JAX package's module of the same name, line
for line.
"""

from __future__ import annotations

import fnmatch
import re
from dataclasses import dataclass

EQ = "=="
NEQ = "!="

# reference: constraint.go alphaNumeric / valuePattern
_KEY_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9\-_.]+$")
_VALUE_RE = re.compile(r"^(?i:[a-z0-9:\-_\s.*()?+\[\]\\^$|/]+)$")


class InvalidConstraint(ValueError):
    pass


@dataclass
class Constraint:
    key: str
    operator: str  # "==" | "!="
    value: str

    def match(self, *whats: str) -> bool:
        """True if any candidate matches per the operator
        (reference: constraint.go Match)."""
        hit = any(w == self.value or fnmatch.fnmatchcase(w, self.value)
                  for w in whats)
        return hit if self.operator == EQ else not hit


def parse(expressions: list[str]) -> list[Constraint]:
    """reference: constraint.go Parse."""
    out = []
    for expr in expressions:
        if NEQ in expr:
            parts, op = expr.split(NEQ, 1), NEQ
        elif EQ in expr:
            parts, op = expr.split(EQ, 1), EQ
        else:
            raise InvalidConstraint(
                f"invalid constraint {expr!r}: expected == or !=")
        key, value = parts[0].strip(), parts[1].strip()
        if not key or not value:
            raise InvalidConstraint(f"invalid constraint {expr!r}")
        if not _KEY_RE.match(key):
            raise InvalidConstraint(f"invalid constraint key {key!r}")
        if not _VALUE_RE.match(value):
            raise InvalidConstraint(f"invalid constraint value {value!r}")
        out.append(Constraint(key=key, operator=op, value=value))
    return out


def node_matches(constraints: list[Constraint], node) -> bool:
    """reference: constraint.go NodeMatches."""
    for c in constraints:
        key = c.key.lower()
        if key == "node.id":
            if not c.match(node.id):
                return False
        elif key == "node.hostname":
            hostname = node.description.hostname if node.description else ""
            if not c.match(hostname):
                return False
        elif key == "node.ip":
            if not c.match(node.status.addr or ""):
                return False
        elif key == "node.role":
            from swarmkit_tpu_torch.api import NodeRole
            role = "manager" if node.role == NodeRole.MANAGER else "worker"
            if not c.match(role):
                return False
        elif key == "node.platform.os":
            plat = node.description.platform if node.description else None
            if not c.match(plat.os if plat else ""):
                return False
        elif key == "node.platform.arch":
            plat = node.description.platform if node.description else None
            if not c.match(plat.architecture if plat else ""):
                return False
        elif key.startswith("node.labels."):
            label = c.key[len("node.labels."):]
            val = node.spec.annotations.labels.get(label, "")
            if not c.match(val):
                return False
        elif key.startswith("engine.labels."):
            label = c.key[len("engine.labels."):]
            engine = node.description.engine if node.description else None
            val = (engine.labels if engine else {}).get(label, "")
            if not c.match(val):
                return False
        else:
            # unknown key: only != can pass (reference behavior)
            if c.operator != NEQ:
                return False
    return True
