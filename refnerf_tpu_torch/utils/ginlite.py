"""A minimal gin-config-compatible parser.

The reference drives everything through gin files + `--gin_bindings` flags
(ref: internal/configs.py:174-194). gin itself is not a dependency of this
framework, so this module implements the subset of the gin language those
configs (and typical user overrides) actually use:

  - `Target.param = <python literal>` bindings (numbers, strings, bools,
    tuples, lists, dicts, None, scientific notation),
  - `@name` / `@scope/name` configurable references (kept as Ref objects),
  - `%MACRO` references and `MACRO = value` macro definitions,
  - `include 'other.gin'`,
  - comments and blank lines,
  - multi-line values inside brackets/parens.

Bindings accumulate left-to-right (later files/bindings win), matching gin's
behavior for plain value bindings.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Any, Dict, List, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class Ref:
  """A `@configurable` reference appearing as a binding value."""
  name: str

  def __repr__(self):
    return f'@{self.name}'


@dataclasses.dataclass(frozen=True)
class Macro:
  """A `%MACRO` reference appearing as a binding value."""
  name: str

  def __repr__(self):
    return f'%{self.name}'


class ParseError(ValueError):
  pass


def _split_top_level(text: str) -> List[str]:
  """Split on commas at bracket depth 0, respecting string literals."""
  parts, depth, start = [], 0, 0
  in_str: Optional[str] = None
  for i, c in enumerate(text):
    if in_str:
      if c == in_str and text[i - 1] != '\\':
        in_str = None
    elif c in ('"', "'"):
      in_str = c
    elif c in '([{':
      depth += 1
    elif c in ')]}':
      depth -= 1
    elif c == ',' and depth == 0:
      parts.append(text[start:i])
      start = i + 1
  tail = text[start:].strip()
  if tail:
    parts.append(tail)
  return parts


def _parse_value(text: str):
  text = text.strip()
  if text.startswith('@'):
    return Ref(text[1:].strip())
  if text.startswith('%'):
    return Macro(text[1:].strip())
  try:
    return ast.literal_eval(text)
  except (ValueError, SyntaxError):
    pass
  # Containers holding @refs / %macros (e.g. "[@a, @b]") are valid gin but
  # not python literals; parse element-wise.
  closer = {'[': ']', '(': ')'}.get(text[:1])
  if closer and text.endswith(closer):
    items = [_parse_value(p) for p in _split_top_level(text[1:-1])]
    return items if text[0] == '[' else tuple(items)
  raise ParseError(f'Cannot parse gin value: {text!r}')


def _gin_repr(v) -> str:
  """A gin-language representation that ginlite itself can re-parse."""
  if isinstance(v, (Ref, Macro)):
    return str(v)
  if isinstance(v, list):
    return '[' + ', '.join(_gin_repr(x) for x in v) + ']'
  if isinstance(v, tuple):
    inner = ', '.join(_gin_repr(x) for x in v)
    return '(' + inner + (',' if len(v) == 1 else '') + ')'
  if isinstance(v, dict):
    return ('{' + ', '.join(f'{k!r}: {_gin_repr(x)}' for k, x in v.items())
            + '}')
  return repr(v)


def _strip_comment(line: str) -> str:
  """Remove a trailing # comment, respecting string literals."""
  out = []
  in_str: Optional[str] = None
  i = 0
  while i < len(line):
    c = line[i]
    if in_str:
      out.append(c)
      if c == in_str and line[i - 1] != '\\':
        in_str = None
    elif c in ('"', "'"):
      in_str = c
      out.append(c)
    elif c == '#':
      break
    else:
      out.append(c)
    i += 1
  return ''.join(out)


def _bracket_depth_delta(text: str) -> int:
  depth = 0
  in_str: Optional[str] = None
  for i, c in enumerate(text):
    if in_str:
      if c == in_str and text[i - 1] != '\\':
        in_str = None
    elif c in ('"', "'"):
      in_str = c
    elif c in '([{':
      depth += 1
    elif c in ')]}':
      depth -= 1
  return depth


def _logical_lines(text: str) -> List[str]:
  """Join physical lines into logical lines (bracket continuation)."""
  lines = []
  buf = ''
  depth = 0
  for raw in text.splitlines():
    stripped = _strip_comment(raw).strip()
    if not stripped and depth == 0:
      continue
    buf = (buf + ' ' + stripped).strip() if buf else stripped
    depth += _bracket_depth_delta(stripped)
    if depth <= 0 and buf:
      lines.append(buf)
      buf = ''
      depth = 0
  if buf:
    lines.append(buf)
  return lines


class GinConfig:
  """Accumulated bindings: {target: {param: value}} plus macros."""

  def __init__(self):
    self.bindings: Dict[str, Dict[str, Any]] = {}
    self.macros: Dict[str, Any] = {}
    self._search_paths: List[str] = ['']

  def add_search_path(self, path: str):
    if path not in self._search_paths:
      self._search_paths.append(path)

  def _resolve_path(self, path: str) -> str:
    for base in self._search_paths:
      candidate = os.path.join(base, path) if base else path
      if os.path.exists(candidate):
        return candidate
    raise FileNotFoundError(f'gin file not found: {path}')

  def parse_line(self, line: str):
    # Keyword statements match on the first whole word: a binding like
    # 'important_flag = True' must NOT be treated as an import.
    head = line.split(None, 1)[0] if line.split() else ''
    if head == 'include':
      rest = line[len('include'):].strip()
      try:
        target = ast.literal_eval(rest)
      except (ValueError, SyntaxError) as e:
        raise ParseError(f'Malformed include: {line!r}') from e
      self.parse_file(target)
      return
    if head in ('import', 'from'):
      return  # module imports are meaningless here; targets resolve by name
    if '=' not in line:
      raise ParseError(f'Malformed gin line: {line!r}')
    lhs, rhs = line.split('=', 1)
    lhs = lhs.strip()
    value = _parse_value(rhs)
    if '.' in lhs:
      # Scoped targets like 'train/Config.param' keep their scope prefix.
      target, param = lhs.rsplit('.', 1)
      if not param.isidentifier() or not all(
          p.isidentifier() for p in target.replace('/', '.').split('.')):
        raise ParseError(f'Malformed gin binding target: {lhs!r}')
      self.bindings.setdefault(target, {})[param] = value
    else:
      if not lhs.isidentifier():
        raise ParseError(f'Malformed gin macro name: {lhs!r}')
      self.macros[lhs] = value

  def parse_string(self, text: str):
    for line in _logical_lines(text):
      self.parse_line(line)

  def parse_file(self, path: str):
    resolved = self._resolve_path(path)
    # Like gin: includes inside this file resolve relative to it first,
    # so shipped config chains load from any working directory.
    own_dir = os.path.dirname(os.path.abspath(resolved))
    self._search_paths.insert(0, own_dir)
    try:
      with open(resolved) as f:
        self.parse_string(f.read())
    finally:
      self._search_paths.remove(own_dir)

  def resolve(self, value):
    """Substitute macros recursively; Refs are returned as-is."""
    if isinstance(value, Macro):
      return self.resolve(self.macros[value.name])
    if isinstance(value, (list, tuple)):
      return type(value)(self.resolve(v) for v in value)
    if isinstance(value, dict):
      return {k: self.resolve(v) for k, v in value.items()}
    return value

  def get(self, target: str, scope: Optional[str] = None) -> Dict[str, Any]:
    """Merged params for `target`, with `scope/target` overriding `target`."""
    out = dict(self.bindings.get(target, {}))
    if scope:
      out.update(self.bindings.get(f'{scope}/{target}', {}))
    return {k: self.resolve(v) for k, v in out.items()}

  def config_str(self) -> str:
    """Dump the merged config (the reference snapshots this to the exp dir,
    configs.py:186-193)."""
    lines = []
    for name in sorted(self.macros):
      lines.append(f'{name} = {_gin_repr(self.macros[name])}')
    for target in sorted(self.bindings):
      for param in sorted(self.bindings[target]):
        v = self.bindings[target][param]
        lines.append(f'{target}.{param} = {_gin_repr(v)}')
    return '\n'.join(lines) + '\n'


def parse_config_files_and_bindings(
    config_files: Optional[Sequence[str]],
    bindings: Optional[Sequence[str]] = None,
    search_paths: Optional[Sequence[str]] = None) -> GinConfig:
  """Parse gin files then override with `--gin_bindings`-style strings."""
  cfg = GinConfig()
  for p in search_paths or []:
    cfg.add_search_path(p)
  for f in config_files or []:
    cfg.parse_file(f)
  for b in bindings or []:
    cfg.parse_string(b)
  return cfg
