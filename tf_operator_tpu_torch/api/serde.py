"""Dataclass <-> camelCase-JSON serialization for the TFJob API model.

The reference operator gets this for free from Kubernetes codegen
(deepcopy/defaulter/clientset generators driven by struct tags, see
reference hack/update-codegen.sh:33-40 and
pkg/apis/tensorflow/v1/zz_generated.deepcopy.go). We instead derive the
wire format from dataclass field names at runtime: snake_case fields map
to camelCase JSON keys, with an optional ``json`` metadata override for
irregular names (e.g. ``clusterIP``).

Every model carries an ``extra`` dict that round-trips unknown keys, so
manifests written for richer Kubernetes pod schemas survive a
load -> default -> store cycle untouched (the reference gets the same
property by watching TFJobs as unstructured objects,
pkg/common/util/v1/unstructured/informer.go:25-63).

The port's copy of tf_operator_tpu/api/serde.py; it imports nothing of that package.
"""

from __future__ import annotations

import dataclasses
import enum
import functools
import typing
from typing import Any, Type, TypeVar, Union

T = TypeVar("T")

_EXTRA_FIELD = "extra"


def camel(name: str) -> str:
    head, *rest = name.split("_")
    return head + "".join(part[:1].upper() + part[1:] for part in rest)


def _json_key(field: dataclasses.Field) -> str:
    return field.metadata.get("json", camel(field.name))


def _unwrap_optional(tp: Any) -> Any:
    if typing.get_origin(tp) is Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return tp


def to_jsonable(value: Any) -> Any:
    """Recursively convert a model value to plain JSON-able Python."""
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        out: dict[str, Any] = {}
        for field in dataclasses.fields(value):
            if field.name == _EXTRA_FIELD:
                continue
            item = getattr(value, field.name)
            if item is None:
                continue
            if item in ({}, []) and not field.metadata.get("keep_empty"):
                continue
            out[_json_key(field)] = to_jsonable(item)
        extra = getattr(value, _EXTRA_FIELD, None)
        if extra:
            for key, item in extra.items():
                out.setdefault(key, to_jsonable(item))
        return out
    if isinstance(value, enum.Enum):
        return value.value
    if isinstance(value, dict):
        return {key: to_jsonable(item) for key, item in value.items()}
    if isinstance(value, (list, tuple)):
        return [to_jsonable(item) for item in value]
    return value


def _coerce(value: Any, tp: Any) -> Any:
    unwrapped = _unwrap_optional(tp)
    was_optional = unwrapped is not tp
    tp = unwrapped
    if value is None:
        # an explicit JSON null for a REQUIRED map/list field means
        # "absent" (k8s apiserver semantics): coerce to the empty
        # collection so validation reports the real problem
        # ("tfReplicaSpecs must be specified") instead of every
        # downstream consumer crashing on a None where the declared
        # type promises a collection
        if not was_optional:
            origin = typing.get_origin(tp)
            if origin is dict:
                return {}
            if origin in (list, tuple):
                return []
        return None
    origin = typing.get_origin(tp)
    if origin in (list, tuple):
        (item_tp,) = typing.get_args(tp) or (Any,)
        return [_coerce(item, item_tp) for item in value]
    if origin is dict:
        args = typing.get_args(tp)
        value_tp = args[1] if len(args) == 2 else Any
        return {key: _coerce(item, value_tp) for key, item in value.items()}
    if isinstance(tp, type):
        if dataclasses.is_dataclass(tp):
            return from_jsonable(value, tp)
        if issubclass(tp, enum.Enum):
            return tp(value)
        if tp is float and isinstance(value, int):
            return float(value)
        if tp is int and isinstance(value, float) and value.is_integer():
            return int(value)
        # Bad specs must fail loudly at admission, not crash the
        # controller later — the failure mode the reference's
        # unstructured-informer design guards against (kubeflow/
        # tf-operator#561, reference informer.go:82-105).
        if tp is int and isinstance(value, bool):
            raise TypeError(f"expected int, got bool ({value!r})")
        if tp in (int, str, bool) and not isinstance(value, tp):
            raise TypeError(
                f"expected {tp.__name__}, got {type(value).__name__} ({value!r})"
            )
    return value


@functools.lru_cache(maxsize=None)
def _class_schema(cls: type):
    """Resolved type hints + json-key map, cached per class: hint
    resolution evals stringified annotations and sits on the controller's
    deserialization hot path."""
    hints = typing.get_type_hints(cls)
    known = {_json_key(field): field for field in dataclasses.fields(cls)}
    return hints, known


def from_jsonable(data: Any, cls: Type[T]) -> T:
    """Build dataclass ``cls`` from a plain JSON-able dict.

    Unknown keys land in ``cls.extra`` (if the model declares one) so
    they survive a round trip; known keys are recursively coerced using
    the declared field types.
    """
    if data is None:
        data = {}
    if not isinstance(data, dict):
        raise TypeError(f"cannot build {cls.__name__} from {type(data).__name__}")
    hints, known = _class_schema(cls)
    kwargs: dict[str, Any] = {}
    extra: dict[str, Any] = {}
    for key, value in data.items():
        field = known.get(key)
        if field is None or field.name == _EXTRA_FIELD:
            extra[key] = value
        else:
            kwargs[field.name] = _coerce(value, hints[field.name])
    obj = cls(**kwargs)
    if extra:
        if not hasattr(obj, _EXTRA_FIELD):
            raise ValueError(
                f"unknown keys {sorted(extra)} for {cls.__name__} (no extra field)"
            )
        getattr(obj, _EXTRA_FIELD).update(extra)
    return obj


def deep_copy(obj: T) -> T:
    """Semantic DeepCopy: round trip through the wire format.

    Plays the role of the generated DeepCopy methods the reference's
    informer-cache discipline relies on (objects from the cache must be
    copied before mutation, reference controller.go:325).
    """
    if obj is None:
        return obj
    return from_jsonable(to_jsonable(obj), type(obj))
