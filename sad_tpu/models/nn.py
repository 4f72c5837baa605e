"""A small module layer for the detection models.

The models are written as dataclass modules that declare named parameters
while they run, the style of a ``linen``-like library: ``@compact``
methods create submodules inline, ``setup`` assigns them as attributes,
``init`` runs a method once and returns the parameters it declared, and
``apply`` runs any method on given parameters. This file implements only
what ``sad_tpu.models`` uses, so the models need nothing beyond JAX.

Parameters live in nested dicts keyed by module name (``{"params":
{"fpn": {"body": {"conv1": {"kernel": ...}}}}}``). A submodule without an
explicit ``name`` is named ``<ClassName>_<n>``, counted per class within
its parent, and ``remat(cls)`` yields a class named ``Checkpoint<cls>``.
These naming rules fix the checkpoint layout (``train/checkpoint.py``), so
they must not change. A parameter's initial value is drawn from the
``init`` key folded with a hash of its path.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import threading
import zlib
from typing import Any, Callable, Optional, Sequence

import jax
import jax.numpy as jnp
from jax import lax

initializers = jax.nn.initializers
relu = jax.nn.relu
sigmoid = jax.nn.sigmoid
softmax = jax.nn.softmax

_CONTEXT = threading.local()  # the stack of modules whose methods are running


def _stack() -> list:
    if not hasattr(_CONTEXT, "stack"):
        _CONTEXT.stack = []
    return _CONTEXT.stack


def compact(fn: Callable) -> Callable:
    """Marks a method that creates its submodules inline. Every wrapped
    method may do so here; the marker documents intent."""
    return fn


@dataclasses.dataclass(frozen=True)
class _Scope:
    params: dict
    rng: Optional[jax.Array]  # None under apply
    path: tuple

    def child(self, name: str) -> "_Scope":
        return _Scope(self.params, self.rng, self.path + (name,))


def _wrap(fn: Callable) -> Callable:
    @functools.wraps(fn)
    def wrapped(self, *args, **kwargs):
        if self._scope is None:
            raise RuntimeError(
                f"{type(self).__name__}.{fn.__name__} called on an unbound "
                "module: use init() or apply()"
            )
        if self._depth == 0:
            self._autoname = {}  # a fresh call re-derives the same names
        self._ensure_setup()
        stack = _stack()
        self._depth += 1
        stack.append(self)
        try:
            return fn(self, *args, **kwargs)
        finally:
            stack.pop()
            self._depth -= 1

    return wrapped


@dataclasses.dataclass(eq=False, repr=False)
class Module:
    """Base class: subclasses become dataclasses whose methods run bound to
    a parameter scope."""

    name: Optional[str] = dataclasses.field(default=None, kw_only=True)

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        dataclasses.dataclass(cls, eq=False, repr=False)
        fields = {f.name for f in dataclasses.fields(cls)}
        for attr, value in list(cls.__dict__.items()):
            if (
                callable(value)
                and attr not in fields
                and not isinstance(value, (staticmethod, classmethod, type))
                and attr != "setup"
                and (attr == "__call__" or not attr.startswith("__"))
            ):
                setattr(cls, attr, _wrap(value))

    def __post_init__(self):
        object.__setattr__(self, "_scope", None)
        object.__setattr__(self, "_depth", 0)
        object.__setattr__(self, "_autoname", {})
        object.__setattr__(self, "_setup_done", False)
        stack = _stack()
        if stack:
            stack[-1]._adopt(self)

    def setup(self):
        """Override to assign submodules as attributes (run once, lazily,
        before the first method call of a bound module)."""

    def _adopt(self, child: "Module") -> None:
        if child.name is None:
            cls = type(child).__name__
            n = self._autoname.get(cls, 0)
            self._autoname[cls] = n + 1
            child.name = f"{cls}_{n}"
        child._scope = self._scope.child(child.name)

    def _ensure_setup(self) -> None:
        if self._setup_done:
            return
        self._setup_done = True
        stack = _stack()
        stack.append(self)
        try:
            self.setup()
        finally:
            stack.pop()

    def param(self, name: str, init_fn: Callable, *init_args) -> jax.Array:
        scope = self._scope
        path = scope.path + (name,)
        tree = scope.params
        if scope.rng is None:
            for key in path:
                if key not in tree:
                    raise KeyError(f"no parameter {'/'.join(path)}")
                tree = tree[key]
            return tree
        for key in scope.path:
            tree = tree.setdefault(key, {})
        if name not in tree:
            seed = zlib.crc32("/".join(path).encode())
            tree[name] = init_fn(jax.random.fold_in(scope.rng, seed), *init_args)
        return tree[name]

    @property
    def is_initializing(self) -> bool:
        return self._scope is not None and self._scope.rng is not None

    def _bind(self, params: dict, rng) -> "Module":
        bound = copy.copy(self)
        object.__setattr__(bound, "_depth", 0)
        object.__setattr__(bound, "_autoname", {})
        object.__setattr__(bound, "_setup_done", False)
        object.__setattr__(bound, "_scope", _Scope(params, rng, ()))
        return bound

    def _run(self, params, rng, method, args, kwargs):
        bound = self._bind(params, rng)
        if method is None:
            fn = bound.__call__
        elif isinstance(method, str):
            fn = getattr(bound, method)
        else:
            fn = functools.partial(_wrap(method), bound)
        return fn(*args, **kwargs)

    def init(self, rng: jax.Array, *args, method=None, **kwargs) -> dict:
        """Runs `method` (default ``__call__``) and returns ``{"params":
        tree}`` with every parameter it declared."""
        params: dict = {}
        self._run(params, rng, method, args, kwargs)
        return {"params": params}

    def apply(self, variables: dict, *args, method=None, **kwargs):
        """Runs `method` (``None``, a method name, or a function of the
        bound module and the arguments) on ``variables["params"]``."""
        return self._run(variables["params"], None, method, args, kwargs)


def remat(cls: type) -> type:
    """`cls` with ``__call__`` rematerialized in the backward pass."""

    def __call__(self, *args, **kwargs):
        call = functools.partial(cls.__call__, self, **kwargs)
        if self.is_initializing:  # parameters are created outside any trace
            return call(*args)
        return jax.checkpoint(call)(*args)

    return type("Checkpoint" + cls.__name__, (cls,), {"__call__": __call__})


def _pairs(v, n: int) -> tuple:
    return (v,) * n if isinstance(v, int) else tuple(v)


def _promote(dtype, *arrays):
    dtype = dtype or jnp.result_type(*[a for a in arrays if a is not None])
    return [None if a is None else jnp.asarray(a, dtype) for a in arrays]


class Dense(Module):
    features: int
    use_bias: bool = True
    dtype: Any = None
    param_dtype: Any = jnp.float32
    kernel_init: Callable = initializers.lecun_normal()
    bias_init: Callable = initializers.zeros

    def __call__(self, x):
        kernel = self.param(
            "kernel", self.kernel_init, (x.shape[-1], self.features),
            self.param_dtype,
        )
        bias = (
            self.param("bias", self.bias_init, (self.features,), self.param_dtype)
            if self.use_bias else None
        )
        x, kernel, bias = _promote(self.dtype, x, kernel, bias)
        y = lax.dot_general(x, kernel, (((x.ndim - 1,), (0,)), ((), ())))
        return y if bias is None else y + bias


class Conv(Module):
    """NHWC convolution with an HWIO kernel."""

    features: int
    kernel_size: Sequence[int]
    strides: Any = 1
    padding: Any = "SAME"
    kernel_dilation: Any = 1
    feature_group_count: int = 1
    use_bias: bool = True
    dtype: Any = None
    param_dtype: Any = jnp.float32
    kernel_init: Callable = initializers.lecun_normal()
    bias_init: Callable = initializers.zeros

    def __call__(self, x):
        ks = tuple(self.kernel_size)
        kernel = self.param(
            "kernel", self.kernel_init,
            ks + (x.shape[-1] // self.feature_group_count, self.features),
            self.param_dtype,
        )
        bias = (
            self.param("bias", self.bias_init, (self.features,), self.param_dtype)
            if self.use_bias else None
        )
        x, kernel, bias = _promote(self.dtype, x, kernel, bias)
        padding = (
            self.padding if isinstance(self.padding, str)
            else tuple(tuple(p) for p in self.padding)
        )
        y = lax.conv_general_dilated(
            x, kernel, _pairs(self.strides, len(ks)), padding,
            rhs_dilation=_pairs(self.kernel_dilation, len(ks)),
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            feature_group_count=self.feature_group_count,
        )
        return y if bias is None else y + bias


class ConvTranspose(Module):
    """NHWC transposed convolution (``lax.conv_transpose``), kernel
    ``kernel_size + (in, features)``."""

    features: int
    kernel_size: Sequence[int]
    strides: Any = 1
    padding: Any = "SAME"
    use_bias: bool = True
    dtype: Any = None
    param_dtype: Any = jnp.float32
    kernel_init: Callable = initializers.lecun_normal()
    bias_init: Callable = initializers.zeros

    def __call__(self, x):
        ks = tuple(self.kernel_size)
        kernel = self.param(
            "kernel", self.kernel_init, ks + (x.shape[-1], self.features),
            self.param_dtype,
        )
        bias = (
            self.param("bias", self.bias_init, (self.features,), self.param_dtype)
            if self.use_bias else None
        )
        x, kernel, bias = _promote(self.dtype, x, kernel, bias)
        y = lax.conv_transpose(
            x, kernel, _pairs(self.strides, len(ks)), self.padding,
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
        )
        return y if bias is None else y + bias


def max_pool(x, window_shape, strides=None, padding="VALID"):
    """Max pool over the spatial axes of an NHWC array."""
    window = tuple(window_shape)
    strides = tuple(strides) if strides is not None else (1,) * len(window)
    if not isinstance(padding, str):
        padding = ((0, 0),) + tuple(tuple(p) for p in padding) + ((0, 0),)
    return lax.reduce_window(
        x, -jnp.inf, lax.max, (1,) + window + (1,), (1,) + strides + (1,),
        padding,
    )
