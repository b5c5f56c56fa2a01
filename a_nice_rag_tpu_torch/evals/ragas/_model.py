"""Typed data models for the judge framework, without pydantic.

The judge framework's 59 input/output/sample classes are declared the
pydantic 2 way (annotated class attributes, ``Field(...)``,
``field_validator(..., mode="before")``), and every other module of
``evals/ragas`` imports ``BaseModel`` from here, so those class bodies
are the JAX package's line for line. Pydantic itself is not a
dependency of the port.

What the prompts and the guided judge read is byte-compatible with
pydantic 2.12:

* ``model_json_schema()``: the same dict, in the same key order
  (every object's keys sorted except under ``properties`` and
  ``default``), with ``$defs`` / ``$ref`` for nested models, ``anyOf``
  with ``{"type": "null"}`` and the default for ``Optional``,
  ``enum`` / ``const`` for ``Literal``, titles from the field names and
  descriptions from ``Field`` and the class docstring.
* ``model_dump_json()``: compact separators, raw UTF-8, floats in the
  shortest round-trip form (``1e-7``, ``0.00001``, ``1e16``), NaN and
  infinities as ``null``.
* validation in pydantic's lax mode: int -> float accepted, ``"1"`` ->
  int accepted, ``1.5`` -> int rejected, int -> str rejected; extra keys
  ignored; model instances kept as they are.

Annotations covered: ``str``, ``int``, ``float``, ``bool``, ``List[...]``,
``Dict[str, ...]``, ``Optional[...]``, ``Union[...]``, ``Literal[...]``,
``Any`` and nested models. Known difference: the text of a
``ValidationError`` (pydantic's names its own version and a URL) is this
module's own; its ``errors()`` carry pydantic's error types.
"""

from __future__ import annotations

import collections.abc
import copy
import inspect
import json
import math
import re
import sys
import types
import typing
from typing import Any, Dict, List

__all__ = ["BaseModel", "Field", "FieldInfo", "ValidationError",
           "field_validator"]


class _UndefinedType:
    def __repr__(self):
        return "PydanticUndefined"


PydanticUndefined = _UndefinedType()


class FieldInfo:
    """One field: its annotation, default or default factory, description."""

    __slots__ = ("annotation", "default", "default_factory", "description")

    def __init__(self, default=PydanticUndefined, default_factory=None,
                 description=None, annotation=None):
        if default is not PydanticUndefined and default_factory is not None:
            raise TypeError("cannot specify both default and default_factory")
        self.default = default
        self.default_factory = default_factory
        self.description = description
        self.annotation = annotation

    def is_required(self) -> bool:
        return (self.default is PydanticUndefined
                and self.default_factory is None)

    def new_default(self):
        """A fresh default: the factory's, or a copy of a mutable one."""
        if self.default_factory is not None:
            return self.default_factory()
        return copy.deepcopy(self.default)

    def _with(self, annotation) -> "FieldInfo":
        return FieldInfo(self.default, self.default_factory,
                         self.description, annotation)


def Field(default=PydanticUndefined, *, default_factory=None,
          description=None):
    return FieldInfo(default, default_factory, description)


class _FieldValidator:
    __slots__ = ("fields", "func")

    def __init__(self, fields, func):
        self.fields = fields
        self.func = func

    def __call__(self, cls, value):
        f = self.func
        if isinstance(f, classmethod):
            return f.__func__(cls, value)
        if isinstance(f, staticmethod):
            return f.__func__(value)
        return f(cls, value)


def field_validator(*fields: str, mode: str):
    """A validator of the raw input of ``fields`` (``mode="before"``, the
    one mode the framework uses); it may raise ValueError or
    AssertionError."""
    if mode != "before":
        raise NotImplementedError(f"field_validator mode={mode!r}")

    def deco(func):
        return _FieldValidator(fields, func)

    return deco


# -- errors --------------------------------------------------------------


class ValidationError(ValueError):
    def __init__(self, title: str, line_errors: List[dict]):
        self.title = title
        self._errors = line_errors
        super().__init__(str(self))

    def errors(self) -> List[dict]:
        return [dict(e) for e in self._errors]

    def __str__(self):
        n = len(self._errors)
        lines = [f"{n} validation error{'s' if n != 1 else ''} "
                 f"for {self.title}"]
        for e in self._errors:
            if e["loc"]:
                lines.append(".".join(str(p) for p in e["loc"]))
            lines.append(
                f"  {e['msg']} [type={e['type']}, "
                f"input_value={_short_repr(e['input'])}, "
                f"input_type={type(e['input']).__name__}]"
            )
        return "\n".join(lines)


def _short_repr(v) -> str:
    r = repr(v)
    return r if len(r) <= 50 else r[:24] + "..." + r[-24:]


_MESSAGES = {
    "missing": "Field required",
    "string_type": "Input should be a valid string",
    "int_type": "Input should be a valid integer",
    "int_parsing": "Input should be a valid integer, unable to parse "
                   "string as an integer",
    "int_from_float": "Input should be a valid integer, got a number with "
                      "a fractional part",
    "int_parsing_size": "Unable to parse input string as an integer, "
                        "exceeded maximum size",
    "finite_number": "Input should be a finite number",
    "float_type": "Input should be a valid number",
    "float_parsing": "Input should be a valid number, unable to parse "
                     "string as a number",
    "bool_type": "Input should be a valid boolean",
    "bool_parsing": "Input should be a valid boolean, unable to interpret "
                    "input",
    "list_type": "Input should be a valid list",
    "dict_type": "Input should be a valid dictionary",
    "none_required": "Input should be None",
    "json_invalid": "Invalid JSON",
}


class _Fail(Exception):
    """Errors of one value, each ``(type, loc, msg, input)``."""

    def __init__(self, errors):
        self.errors = errors


def _fail(kind, value, loc=(), msg=None):
    raise _Fail([{"type": kind, "loc": tuple(loc),
                  "msg": msg or _MESSAGES[kind], "input": value}])


def _at(loc, fail: _Fail) -> _Fail:
    for e in fail.errors:
        e["loc"] = tuple(loc) + e["loc"]
    return fail


# -- scalar coercion (pydantic 2 lax mode) --------------------------------

# Rust's char::is_whitespace: what pydantic-core trims from numeric
# strings (Python's str.strip also takes \x1c-\x1f, which it does not).
_RUST_WS = ("\t\n\x0b\x0c\r \x85\xa0\u1680\u2000\u2001\u2002\u2003"
            "\u2004\u2005\u2006\u2007\u2008\u2009\u200a\u2028\u2029\u202f"
            "\u205f\u3000")
_INT_STR = re.compile(r"([+-]?)([0-9](?:_?[0-9])*)(?:\.0+)?")
_FLOAT_STR = re.compile(
    r"[+-]?(?:inf|infinity|nan|(?:[0-9]+\.?[0-9]*|\.[0-9]+)"
    r"(?:e[+-]?[0-9]+)?)", re.IGNORECASE)
_TRUE = {"1", "on", "t", "true", "y", "yes"}
_FALSE = {"0", "off", "f", "false", "n", "no"}
_I64 = 2.0 ** 63


def _v_str(v, strict):
    if isinstance(v, str):
        return str(v)
    _fail("string_type", v)


def _v_int(v, strict):
    if isinstance(v, bool):
        if strict:
            _fail("int_type", v)
        return int(v)
    if isinstance(v, int):
        return int(v)
    if strict:
        _fail("int_type", v)
    if isinstance(v, float):
        if not math.isfinite(v):
            _fail("finite_number", v)
        if v % 1:
            _fail("int_from_float", v)
        if not -_I64 < v < _I64:
            _fail("int_parsing_size", v)
        return int(v)
    if isinstance(v, str):
        m = _INT_STR.fullmatch(v.strip(_RUST_WS))
        if m is None:
            _fail("int_parsing", v)
        return int(m.group(1) + m.group(2).replace("_", ""))
    _fail("int_type", v)


def _v_float(v, strict):
    if isinstance(v, bool):
        if strict:
            _fail("float_type", v)
        return float(v)
    if isinstance(v, (int, float)):
        try:
            return float(v)
        except OverflowError:
            _fail("float_parsing", v)
    if strict:
        _fail("float_type", v)
    if isinstance(v, str):
        s = v.strip(_RUST_WS)
        if s.startswith("_") or s.endswith("_") or "__" in s:
            _fail("float_parsing", v)
        s = s.replace("_", "")
        if _FLOAT_STR.fullmatch(s) is None:
            _fail("float_parsing", v)
        return float(s)
    _fail("float_type", v)


def _v_bool(v, strict):
    if isinstance(v, bool):
        return v
    if strict:
        _fail("bool_type", v)
    if isinstance(v, int):
        if v in (0, 1):
            return bool(v)
        _fail("bool_parsing" if -_I64 <= v < _I64 else "bool_type", v)
    if isinstance(v, float):
        if not math.isfinite(v) or v % 1 or not -_I64 < v < _I64:
            _fail("bool_type", v)
        if v in (0.0, 1.0):
            return bool(v)
        _fail("bool_parsing", v)
    if isinstance(v, str):
        low = v.lower()
        if low in _TRUE:
            return True
        if low in _FALSE:
            return False
        _fail("bool_parsing", v)
    _fail("bool_type", v)


_SCALARS = {str: _v_str, int: _v_int, float: _v_float, bool: _v_bool}
_LIST_LIKE = (list, tuple, set, frozenset)


def _literal_repr(expected) -> str:
    shown = [repr(e) for e in expected]
    if len(shown) == 1:
        return shown[0]
    return ", ".join(shown[:-1]) + " or " + shown[-1]


def _v_literal(expected, v, strict):
    if (isinstance(v, int) and not isinstance(v, bool)
            and not -_I64 <= v < _I64
            and any(type(e) is int for e in expected)):
        _fail("int_parsing_size", v)  # pydantic reads an i64 first
    for e in expected:
        if e is None:
            if v is None:
                return e
        elif isinstance(e, bool):
            if isinstance(v, bool) and v is e:
                return e
        elif isinstance(e, int):
            if strict:
                if type(v) is int and v == e:
                    return e
            elif isinstance(v, (int, float)) and v == e:
                return e
        elif isinstance(e, str):
            if isinstance(v, str) and v == e:
                return e
        elif v == e:
            return e
    _fail("literal_error", v,
          msg=f"Input should be {_literal_repr(expected)}")


# -- annotations -----------------------------------------------------------


def _is_model(tp) -> bool:
    return isinstance(tp, type) and issubclass(tp, BaseModel)


def _union_args(tp):
    origin = typing.get_origin(tp)
    if origin is typing.Union or origin is types.UnionType:
        return typing.get_args(tp)
    return None


def _model_exact(tp, v) -> bool:
    return (type(v) is tp if _is_model(tp)
            else tp in _SCALARS and type(v) is tp)


def _validate(tp, v, strict=False):
    """``tp``-validated ``v``; raises _Fail."""
    if tp is Any or tp is object:
        return v
    if tp is None or tp is type(None):
        if v is None:
            return None
        _fail("none_required", v)
    members = _union_args(tp)
    if members is not None:
        return _v_union(members, v, strict)
    if tp in _SCALARS:
        return _SCALARS[tp](v, strict)
    if _is_model(tp):
        return tp._validate_value(v, strict)
    origin = typing.get_origin(tp)
    args = typing.get_args(tp)
    if origin is typing.Literal:
        return _v_literal(args, v, strict)
    if origin in (list, List) or tp is list:
        if not (isinstance(v, list) if strict else
                isinstance(v, _LIST_LIKE)):
            _fail("list_type", v)
        item = args[0] if args else Any
        out, errs = [], []
        for i, x in enumerate(v):
            try:
                out.append(_validate(item, x, strict))
            except _Fail as f:
                errs.extend(_at((i,), f).errors)
        if errs:
            raise _Fail(errs)
        return out
    if origin in (dict, Dict) or tp is dict:
        if not (isinstance(v, dict) if strict else
                isinstance(v, collections.abc.Mapping)):
            _fail("dict_type", v)
        kt, vt = args if args else (Any, Any)
        out, errs = {}, []
        for k, x in v.items():
            try:
                k2 = _validate(kt, k, strict)
            except _Fail as f:
                errs.extend(_at((k, "[key]"), f).errors)
                continue
            try:
                out[k2] = _validate(vt, x, strict)
            except _Fail as f:
                errs.extend(_at((k,), f).errors)
        if errs:
            raise _Fail(errs)
        return out
    raise TypeError(f"unsupported annotation {tp!r}")


def _v_union(members, v, strict):
    """Pydantic's smart mode: Optional first, then an exact type match,
    then strict, then lax; among model successes the one that set the
    most fields wins, leftmost on a tie."""
    if v is None and type(None) in members:
        return None
    members = [m for m in members if m is not type(None)]
    if len(members) == 1:
        return _validate(members[0], v, strict)
    for m in members:
        if _model_exact(m, v):
            return v
    for mode in ((True,) if strict else (True, False)):
        best, errs = None, []
        for m in members:
            try:
                out = _validate(m, v, mode)
            except _Fail as f:
                errs.extend(f.errors)
                continue
            n = (len(out.model_fields_set)
                 if isinstance(out, BaseModel) else -1)
            if best is None or n > best[0]:
                best = (n, out)
        if best is not None:
            return best[1]
    raise _Fail(errs)


# -- serialization ---------------------------------------------------------


def _dump(tp, v, json_mode):
    """``v`` dumped by its annotation (pydantic serializes a field by
    its declared type, so a subclass instance in a base-class field
    dumps the base class's fields)."""
    if v is None:
        return None
    members = _union_args(tp)
    if members is not None:
        members = [m for m in members if m is not type(None)]
        pick = next((m for m in members if _model_exact(m, v)), None)
        if pick is None:
            pick = next((m for m in members
                         if _is_model(m) and isinstance(v, m)), Any)
        return _dump(pick, v, json_mode)
    if _is_model(tp) and isinstance(v, tp):
        return {name: _dump(info.annotation, getattr(v, name), json_mode)
                for name, info in tp.model_fields.items()}
    origin = typing.get_origin(tp)
    args = typing.get_args(tp)
    if (origin in (list, List) and args
            and isinstance(v, (list, tuple))):
        return [_dump(args[0], x, json_mode) for x in v]
    if (origin in (dict, Dict) and args
            and isinstance(v, dict)):
        return {_dump_key(k, json_mode): _dump(args[1], x, json_mode)
                for k, x in v.items()}
    return _infer(v, json_mode)


def _dump_key(k, json_mode):
    if not json_mode or isinstance(k, str):
        return k
    if isinstance(k, bool):
        return "true" if k else "false"
    return str(k)


def _infer(v, json_mode):
    if isinstance(v, BaseModel):
        return _dump(type(v), v, json_mode)
    if isinstance(v, dict):
        return {_dump_key(k, json_mode): _infer(x, json_mode)
                for k, x in v.items()}
    if isinstance(v, list):
        return [_infer(x, json_mode) for x in v]
    if isinstance(v, (tuple, set, frozenset)):
        items = [_infer(x, json_mode) for x in v]
        return items if json_mode else type(v)(items)
    return v


def _float_json(v: float) -> str:
    """The shortest round-trip digits of ``v`` in ryu's layout (what
    pydantic-core writes): decimal for exponents -5..15, else ``1e-7``,
    ``1.5e300`` with no ``+`` and no padded exponent."""
    if not math.isfinite(v):
        return "null"
    r = repr(v)
    sign = "-" if r[0] == "-" else ""
    mant, _, exp = r.lstrip("-").partition("e")
    ip, _, fp = mant.partition(".")
    digits = (ip + fp).lstrip("0")
    if not digits:
        return sign + "0.0"
    # value = 0.<digits> x 10**kk
    kk = len(ip) + int(exp or 0) - (len(ip + fp) - len((ip + fp).lstrip("0")))
    digits = digits.rstrip("0")
    n = len(digits)
    if 0 <= kk - n and kk <= 16:
        out = digits + "0" * (kk - n) + ".0"
    elif 0 < kk <= 16:
        out = digits[:kk] + "." + digits[kk:]
    elif -5 < kk <= 0:
        out = "0." + "0" * (-kk) + digits
    elif n == 1:
        out = f"{digits}e{kk - 1}"
    else:
        out = f"{digits[0]}.{digits[1:]}e{kk - 1}"
    return sign + out


def _to_json(v, parts: list) -> None:
    if v is None:
        parts.append("null")
    elif v is True:
        parts.append("true")
    elif v is False:
        parts.append("false")
    elif isinstance(v, str):
        parts.append(json.dumps(v, ensure_ascii=False))
    elif isinstance(v, int):
        parts.append(str(int(v)))
    elif isinstance(v, float):
        parts.append(_float_json(v))
    elif isinstance(v, dict):
        parts.append("{")
        for i, (k, x) in enumerate(v.items()):
            if i:
                parts.append(",")
            parts.append(json.dumps(k, ensure_ascii=False))
            parts.append(":")
            _to_json(x, parts)
        parts.append("}")
    elif isinstance(v, list):
        parts.append("[")
        for i, x in enumerate(v):
            if i:
                parts.append(",")
            _to_json(x, parts)
        parts.append("]")
    else:
        raise TypeError(f"cannot serialize {type(v).__name__} to JSON")


# -- JSON Schema -------------------------------------------------------------


def _title(name: str) -> str:
    return name.title().replace("_", " ").strip()


def _jsonable(v):
    return _infer(v, True)


def _title_should_be_set(tp) -> bool:
    """Pydantic sets no field title on a model (or Optional model): the
    ``$ref`` target carries the class's own."""
    if _is_model(tp):
        return False
    members = _union_args(tp)
    if members is not None:
        rest = [m for m in members if m is not type(None)]
        if len(rest) == 1 and len(rest) < len(members):
            return _title_should_be_set(rest[0])
    return True


def _flat_any_of(schemas):
    out = []
    for s in schemas:
        if "anyOf" in s and len(s) == 1:
            out.extend(s["anyOf"])
        else:
            out.append(s)
    return {"anyOf": out}


_LITERAL_TYPES = {str: "string", int: "integer", float: "number",
                  bool: "boolean", list: "array", type(None): "null"}


def _type_schema(tp, defs) -> dict:
    if tp is Any or tp is object:
        return {}
    if tp is None or tp is type(None):
        return {"type": "null"}
    if tp in _SCALARS:
        return {"type": {str: "string", int: "integer", float: "number",
                         bool: "boolean"}[tp]}
    if _is_model(tp):
        name = tp.__name__
        if name not in defs:
            defs[name] = None  # placeholder against recursion
            defs[name] = tp._schema(defs)
        return {"$ref": f"#/$defs/{name}"}
    members = _union_args(tp)
    if members is not None:
        rest = [m for m in members if m is not type(None)]
        inner = (_type_schema(rest[0], defs) if len(rest) == 1
                 else _flat_any_of([_type_schema(m, defs) for m in rest]))
        if len(rest) == len(members):
            return inner
        return _flat_any_of([inner, {"type": "null"}])
    origin = typing.get_origin(tp)
    args = typing.get_args(tp)
    if origin is typing.Literal:
        expected = [_jsonable(a) for a in args]
        out = ({"const": expected[0]} if len(expected) == 1
               else {"enum": expected})
        kinds = {type(e) for e in expected}
        if len(kinds) == 1:
            kind = _LITERAL_TYPES.get(kinds.pop())
            if kind is not None:
                out["type"] = kind
        return out
    if origin in (list, List) or tp is list:
        return {"items": _type_schema(args[0] if args else Any, defs),
                "type": "array"}
    if origin in (dict, Dict) or tp is dict:
        vt = args[1] if args else Any
        vs = _type_schema(vt, defs)
        return {"additionalProperties": vs if vs else True,
                "type": "object"}
    raise TypeError(f"no JSON schema for annotation {tp!r}")


def _sort(value, parent_key=None):
    """pydantic's GenerateJsonSchema.sort: keys sorted at every level
    except directly under 'properties' and 'default'."""
    if isinstance(value, dict):
        keys = value.keys()
        if parent_key not in ("properties", "default"):
            keys = sorted(keys)
        return {k: _sort(value[k], parent_key=k) for k in keys}
    if isinstance(value, list):
        return [_sort(x, parent_key) for x in value]
    return value


# -- the model class ---------------------------------------------------------


def _is_classvar(ann) -> bool:
    if isinstance(ann, str):
        return re.match(r"\s*(typing\.)?ClassVar\b", ann) is not None
    return ann is typing.ClassVar or typing.get_origin(ann) is typing.ClassVar


class _ModelMeta(type):
    def __new__(mcs, name, bases, ns, **kw):
        own = {}
        validators = {}
        for key, value in list(ns.items()):
            if isinstance(value, _FieldValidator):
                validators[key] = ns.pop(key)
        for key, ann in ns.get("__annotations__", {}).items():
            if key.startswith("_") or _is_classvar(ann):
                continue
            value = ns.pop(key, PydanticUndefined)
            own[key] = (ann, value if isinstance(value, FieldInfo)
                        else FieldInfo(default=value))
        cls = super().__new__(mcs, name, bases, ns, **kw)
        cls.__own_fields__ = own
        cls.__own_validators__ = validators
        frame = sys._getframe(1)
        cls.__localns__ = (None if frame.f_locals is frame.f_globals
                           else dict(frame.f_locals))
        cls.__fields_cache__ = None
        return cls

    @property
    def model_fields(cls) -> Dict[str, FieldInfo]:
        fields = cls.__dict__.get("__fields_cache__")
        if fields is None:
            fields = cls._collect_fields()
            cls.__fields_cache__ = fields
        return fields


class BaseModel(metaclass=_ModelMeta):
    """pydantic 2's ``BaseModel`` surface that the judge framework uses."""

    __slots__ = ("__dict__", "__pydantic_fields_set__")

    # -- class set-up --------------------------------------------------------

    @classmethod
    def _collect_fields(cls) -> Dict[str, FieldInfo]:
        fields: Dict[str, FieldInfo] = {}
        for base in reversed(cls.__bases__):
            if _is_model(base) and base is not BaseModel:
                fields.update(base.model_fields)
        module = sys.modules.get(cls.__module__)
        globalns = dict(vars(module)) if module is not None else {}
        localns = dict(cls.__localns__ or {})
        localns.setdefault(cls.__name__, cls)
        for name, (ann, info) in cls.__own_fields__.items():
            tp = eval(ann, globalns, localns) if isinstance(ann, str) else ann
            fields[name] = info._with(tp)
        return fields

    @classmethod
    def _validators(cls, name: str):
        out = []
        for klass in reversed(cls.__mro__):
            for v in klass.__dict__.get("__own_validators__", {}).values():
                if name in v.fields:
                    out.append(v)
        return out

    # -- construction / validation --------------------------------------------

    def __init__(self, **data):
        try:
            values, fields_set = type(self)._fill(data, False)
        except _Fail as f:
            raise ValidationError(type(self).__name__, f.errors) from None
        self.__dict__.update(values)
        object.__setattr__(self, "__pydantic_fields_set__", fields_set)

    @classmethod
    def _fill(cls, data, strict):
        values, fields_set, errs = {}, set(), []
        for name, info in cls.model_fields.items():
            if name not in data:
                if info.is_required():
                    errs.append({"type": "missing", "loc": (name,),
                                 "msg": _MESSAGES["missing"],
                                 "input": dict(data)})
                else:
                    values[name] = info.new_default()
                continue
            raw = data[name]
            fields_set.add(name)
            try:
                for v in cls._validators(name):
                    raw = cls._run_validator(v, raw)
                values[name] = _validate(info.annotation, raw, strict)
            except _Fail as f:
                errs.extend(_at((name,), f).errors)
        if errs:
            raise _Fail(errs)
        return values, fields_set

    @classmethod
    def _run_validator(cls, validator, value):
        try:
            return validator(cls, value)
        except ValidationError as e:
            # A model built inside the validator: its errors, at its locs.
            raise _Fail(e.errors()) from None
        except (ValueError, AssertionError) as e:
            _fail("value_error", value, msg=f"Value error, {e}")

    @classmethod
    def _validate_value(cls, v, strict):
        if isinstance(v, cls):
            return v
        if not isinstance(v, collections.abc.Mapping) or (
                strict and not isinstance(v, dict)):
            _fail("model_type", v, msg=(
                "Input should be a valid dictionary or instance of "
                f"{cls.__name__}"))
        values, fields_set = cls._fill(v, strict)
        obj = cls.__new__(cls)
        obj.__dict__.update(values)
        object.__setattr__(obj, "__pydantic_fields_set__", fields_set)
        return obj

    @classmethod
    def model_validate(cls, obj):
        try:
            return cls._validate_value(obj, False)
        except _Fail as f:
            raise ValidationError(cls.__name__, f.errors) from None

    @classmethod
    def model_validate_json(cls, json_data):
        if isinstance(json_data, (bytes, bytearray)):
            json_data = bytes(json_data).decode("utf-8")
        try:
            obj = json.loads(json_data)
        except ValueError as e:
            raise ValidationError(cls.__name__, [{
                "type": "json_invalid", "loc": (), "input": json_data,
                "msg": f"Invalid JSON: {e}"}]) from None
        return cls.model_validate(obj)

    # -- serialization ------------------------------------------------------

    @property
    def model_fields_set(self) -> set:
        return self.__pydantic_fields_set__

    def model_dump(self) -> Dict[str, Any]:
        return _dump(type(self), self, False)

    def model_dump_json(self, indent=None) -> str:
        if indent is not None:
            raise NotImplementedError("model_dump_json(indent=...)")
        parts: list = []
        _to_json(_dump(type(self), self, True), parts)
        return "".join(parts)

    @classmethod
    def _schema(cls, defs) -> dict:
        props, required = {}, []
        for name, info in cls.model_fields.items():
            s = dict(_type_schema(info.annotation, defs))
            if _title_should_be_set(info.annotation):
                s["title"] = _title(name)
            if info.description is not None:
                s["description"] = info.description
            if info.is_required():
                required.append(name)
            elif info.default_factory is None:
                s["default"] = _jsonable(info.default)
            props[name] = s
        out = {"properties": props}
        if required:
            out["required"] = required
        out["title"] = cls.__name__
        out["type"] = "object"
        doc = cls.__dict__.get("__doc__")
        if doc:
            out["description"] = inspect.cleandoc(doc)
        return out

    @classmethod
    def model_json_schema(cls) -> Dict[str, Any]:
        defs: Dict[str, dict] = {}
        top = cls._schema(defs)
        defs.pop(cls.__name__, None)
        if defs:
            top = {"$defs": defs, **top}
        return _sort(top)

    # -- object protocol -------------------------------------------------------

    def __eq__(self, other):
        if not isinstance(other, BaseModel):
            return NotImplemented
        return type(self) is type(other) and self.__dict__ == other.__dict__

    __hash__ = None

    def __repr__(self):
        args = ", ".join(f"{k}={v!r}" for k, v in self.__dict__.items())
        return f"{type(self).__name__}({args})"
