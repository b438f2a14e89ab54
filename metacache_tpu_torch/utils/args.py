"""Hand-rolled '-flag value' argument parser mirroring the reference's
args_parser (src/args_parser.h:36-591): leading non-flag tokens are
positionals; a token starting with '-' (and not a pure number) starts a flag
whose value is the following non-flag token; flags may be queried under
multiple aliases.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union


def _is_flag(token: str) -> bool:
    if not token.startswith("-") or len(token) < 2:
        return False
    # negative numbers are values, not flags
    try:
        float(token)
        return False
    except ValueError:
        return True


class ArgsParser:
    def __init__(self, argv: Sequence[str]):
        self.positionals: List[str] = []
        self._flags: List[tuple] = []  # (name, [values])
        cur: Optional[List[str]] = None
        for tok in argv:
            if _is_flag(tok):
                cur = []
                self._flags.append((tok.lstrip("-"), cur))
            elif cur is None:
                self.positionals.append(tok)
            else:
                cur.append(tok)

    def contains(self, names: Union[str, Sequence[str]]) -> bool:
        if isinstance(names, str):
            names = [names]
        return any(n == name for name, _ in self._flags for n in names)

    def get(self, names: Union[str, Sequence[str]], default=None, type=str):
        if isinstance(names, str):
            names = [names]
        for name, values in self._flags:
            if name in names and values:
                try:
                    return type(values[0])
                except (TypeError, ValueError):
                    return default
        return default

    def get_all(self, names: Union[str, Sequence[str]]) -> List[str]:
        if isinstance(names, str):
            names = [names]
        out: List[str] = []
        for name, values in self._flags:
            if name in names:
                out.extend(values)
        return out

    def flag_names(self) -> List[str]:
        return [name for name, _ in self._flags]
