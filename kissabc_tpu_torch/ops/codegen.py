"""User callables -> CUDA device functions: the port's counterpart of
Pallas tracing ``jnp`` callables into a Mosaic kernel.

The generic kernels (``csrc/generic.cuh``) run the user's model inside
the kernel: ``draw(theta, eps)`` makes each simulated value, the
optional ``stats`` are the summary functions, ``reduce_cost(theta,
moments)`` turns the moments into a cost, and the prior's logpdf gates
the proposals. The user writes them once, in PyTorch. Called on real
tensors they are the plain versions; called on ``Sym`` values they
record an expression graph, which this module emits as
``__device__ __forceinline__`` C++ functions:

    float draw(const float* th, float e);
    float stat_j(float x);                    (one per entry of stats)
    float reduce_cost(const float* th, const float* m);
    float prior_logpdf(const float* th);
    void prior_push(const float* th, float* out);

The tempered sweep (``csrc/tempered.cuh``) runs a deterministic
log-likelihood of the pushed parameters, ``loglike(theta)``, whose data
enter as Python or numpy constants (``generate_tempered``):

    float loglike(const float* th);

The scan kernel (``csrc/scan.cuh``) runs a sequential model: ``init(
theta)``, ``step(theta, x, eps, t)`` and ``observe(theta, x, t, obs)``
become (``generate_scan``)

    void scan_init(const float* th, float* x);
    void scan_step(const float* th, const float* x, float e, int t,
                   float* xn);
    void scan_observe(const float* th, const float* x, int t,
                      const float* obs, float* o);

Supported, exactly what the JAX package's tests, bench models and
examples use: ``+ - * /``, unary ``-``, ``**`` with an integer power, the
comparisons, ``.to(torch.float32)`` / ``.float()`` of a boolean or of
the int32 step index ``t`` (which also takes ``%``, ``+ - *`` and
comparisons with integers, promoting as PyTorch does), ``torch.where``,
``sqrt``, ``exp``, ``log``, ``log1p``, ``expm1``, ``tanh``, ``sin``,
``cos``, ``abs``, ``square``, ``hypot``, ``maximum``, ``minimum``,
``clamp`` (with number or tensor bounds), ``ones_like`` and
``zeros_like``, as ``torch.*`` functions or as tensor methods. Anything else raises ``NotImplementedError`` naming
the op, when the cost or sweep is built; nothing falls back to the plain
version.

The prior's ``prior_logpdf`` comes from a per-family table
(``_marginal_logpdf``): Uniform, Normal, DiscreteUniform and Truncated of
the first two are written out; every other family with an entry
(``_TRACED``, and Truncated, Affine and Mixture of such) is its own torch
``logpdf`` traced by the same tracer, which then also takes ``lgamma``,
``asinh``, float powers, ``full_like``, ``& | ~`` on booleans and
``distributions.i0e`` (``kt_i0e`` of ``csrc/common.cuh``).

Each emitted operation repeats what PyTorch does for the same
expression, so the kernel and the plain version round alike: Python
numbers become float32 constants, written as exact bit patterns
(``__uint_as_float(0x...u)``), ``c / x`` is ``reciprocal(x) * c`` (as
``Tensor.__rtruediv__``), ``x / c`` is ``x * (1/c)`` with ``1/c`` rounded
to float32 (as PyTorch divides a CUDA tensor by a scalar,
``div_true_kernel_cuda``; on the CPU it divides, up to one ulp away),
and small integer powers are products. The generated translation units
are compiled without FMA contraction.
"""

from __future__ import annotations

import numbers
import operator
from dataclasses import dataclass

import numpy as np
import torch

from .. import distributions as D

# C functions of the unary ops (float32 versions from the CUDA math library)
_UNARY_C = {"sqrt": "sqrtf", "exp": "expf", "log": "logf",
            "log1p": "log1pf", "expm1": "expm1f", "tanh": "tanhf",
            "sin": "sinf", "cos": "cosf", "abs": "fabsf",
            "lgamma": "lgammaf", "asinh": "asinhf", "i0e": "kt_i0e"}
_UNARY = tuple(_UNARY_C) + ("square",)
_COMPARE_C = {"lt": "<", "le": "<=", "gt": ">", "ge": ">=", "eq": "==",
              "ne": "!="}
_ARITH_C = {"add": "+", "sub": "-", "mul": "*", "div": "/"}
_TORCH_FUNCS = {getattr(torch, name): name for name in tuple(
    n for n in _UNARY if n != "i0e") + (
    "where", "hypot", "maximum", "minimum", "clamp", "ones_like",
    "zeros_like", "full_like")}
_MAX_ARGS = 16   # the most theta leaves or moments a traced callable gets
# torch functions that only the prior table's traced logpdfs may use (a
# user model's surface stays the one above; float powers, ``& | ~`` and
# ``i0e`` are checked where they are recorded): allowed while a prior
# entry is traced
_PRIOR_ONLY = frozenset({"lgamma", "asinh", "full_like"})
_tracing_prior = [False]


def _prior_only(op):
    if not _tracing_prior[0]:
        raise NotImplementedError(
            f"op {op!r} is not supported in a model compiled into the "
            f"generic kernels (supported: {', '.join(_supported())})")


def _is_number(v):
    return isinstance(v, numbers.Real) or (
        isinstance(v, torch.Tensor) and v.numel() == 1
        and not isinstance(v, Sym))


def _number(v):
    return float(v.item()) if isinstance(v, torch.Tensor) else float(v)


def _is_int(v):
    """An int32 value: an integer Sym (the scan's step index ``t`` and
    what is computed from it with integers) or a Python integer."""
    if isinstance(v, Sym):
        return v.kind == "i"
    return isinstance(v, numbers.Integral) and not isinstance(v, bool)


def _int_operand(v):
    return v if isinstance(v, Sym) else int(v)


class Sym:
    """A symbolic float32 (``kind="f"``), boolean (``kind="b"``) or int32
    (``kind="i"``) value: one node of the recorded expression graph.
    Leaves are ``theta`` (argument k), ``noise`` (the draw's or step's
    eps), ``x`` (a stat's input), ``m`` (moment j), and for the scan
    model ``xs`` (state leaf j), ``t`` (the int32 step index) and ``obs``
    (series leaf j at t); constants are plain Python numbers in
    ``args``."""

    __slots__ = ("op", "args", "kind")
    __array_ufunc__ = None   # numpy scalars defer to the reflected op

    def __init__(self, op, args=(), kind="f"):
        self.op, self.args, self.kind = op, tuple(args), kind

    __hash__ = object.__hash__

    def __repr__(self):
        return f"Sym({self.op}, kind={self.kind})"

    def __bool__(self):
        raise TypeError(
            "a traced model value has no truth value: write data-dependent "
            "choices with torch.where")

    def __iter__(self):
        raise TypeError("a traced scalar is not iterable")

    def __getitem__(self, index):
        raise TypeError("a traced scalar cannot be indexed")

    def __getattr__(self, name):
        if name.startswith("__"):   # protocol probes (numpy, copy, ...)
            raise AttributeError(name)
        raise NotImplementedError(
            f"op {name!r} is not supported in a model compiled into the "
            f"generic kernels (supported: {', '.join(_supported())})")

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        name = _TORCH_FUNCS.get(func)
        if name is None:
            raise NotImplementedError(
                f"op {getattr(func, '__name__', func)!r} is not supported in "
                "a model compiled into the generic kernels (supported: "
                f"{', '.join(_supported())})")
        kwargs = kwargs or {}
        if name in _PRIOR_ONLY:
            _prior_only(name)
        if name in _UNARY:
            return _unary(name, *args, **kwargs)
        if name == "where":
            return _where(*args, **kwargs)
        if name in ("hypot", "maximum", "minimum"):
            return _binary_fn(name, *args, **kwargs)
        if name == "clamp":
            return args[0].clamp(*args[1:], **kwargs)
        if name == "full_like":   # a constant: its fill value
            value = args[1] if len(args) > 1 else kwargs["fill_value"]
            return _number(value)
        return Sym(name, (args[0],))   # ones_like, zeros_like

    # arithmetic --------------------------------------------------------
    def __add__(self, o):
        return _arith("add", self, o)

    def __radd__(self, o):
        return _arith("add", o, self)

    def __sub__(self, o):
        return _arith("sub", self, o)

    def __rsub__(self, o):
        return _arith("sub", o, self)

    def __mul__(self, o):
        return _arith("mul", self, o)

    def __rmul__(self, o):
        return _arith("mul", o, self)

    def __truediv__(self, o):
        return _arith("div", self, o)

    def __rtruediv__(self, o):
        if not _is_number(o):
            return NotImplemented
        return Sym("rdiv", (_as_float(self), _number(o)))

    def __mod__(self, o):
        return _mod(self, o)

    def __rmod__(self, o):
        return _mod(o, self)

    def __floordiv__(self, o):
        raise NotImplementedError(
            "op 'floor_divide' is not supported in a model compiled into the "
            "generic kernels")

    __rfloordiv__ = __floordiv__

    def __neg__(self):
        if self.kind == "i":
            return Sym("neg", (self,), kind="i")
        return Sym("neg", (_as_float(self),))

    def __pow__(self, p):
        if self.kind == "i":
            raise NotImplementedError(
                "op 'pow' of the integer step index is not supported in a "
                "model compiled into the generic kernels")
        if not _is_number(p):
            raise NotImplementedError(
                f"op 'pow' with exponent {p!r}: only integer powers are "
                "supported in a model compiled into the generic kernels")
        if float(_number(p)).is_integer():
            return Sym("pow", (_as_float(self), int(_number(p))))
        _prior_only("pow")
        return Sym("powf", (_as_float(self), _number(p)))

    def __rpow__(self, o):
        raise NotImplementedError(
            "op 'pow' with a traced exponent is not supported in a model "
            "compiled into the generic kernels")

    def __abs__(self):
        return _unary("abs", self)

    # boolean logic -----------------------------------------------------
    def __and__(self, o):
        return _logic("and", self, o)

    __rand__ = __and__

    def __or__(self, o):
        return _logic("or", self, o)

    __ror__ = __or__

    def __invert__(self):
        _prior_only("not")
        if self.kind != "b":
            raise NotImplementedError(
                "op '~' is supported only on a boolean in a model compiled "
                "into the generic kernels")
        return Sym("not", (self,), kind="b")

    # comparisons -------------------------------------------------------
    def __lt__(self, o):
        return _compare("lt", self, o)

    def __le__(self, o):
        return _compare("le", self, o)

    def __gt__(self, o):
        return _compare("gt", self, o)

    def __ge__(self, o):
        return _compare("ge", self, o)

    def __eq__(self, o):
        return _compare("eq", self, o)

    def __ne__(self, o):
        return _compare("ne", self, o)

    # tensor methods ----------------------------------------------------
    def sqrt(self):
        return _unary("sqrt", self)

    def exp(self):
        return _unary("exp", self)

    def log(self):
        return _unary("log", self)

    def log1p(self):
        return _unary("log1p", self)

    def expm1(self):
        return _unary("expm1", self)

    def tanh(self):
        return _unary("tanh", self)

    def sin(self):
        return _unary("sin", self)

    def cos(self):
        return _unary("cos", self)

    def square(self):
        return _unary("square", self)

    def i0e(self):   # distributions.i0e of a traced value: kt_i0e
        _prior_only("i0e")
        return _unary("i0e", self)

    def abs(self):
        return _unary("abs", self)

    def hypot(self, o):
        return _binary_fn("hypot", self, o)

    def maximum(self, o):
        return _binary_fn("maximum", self, o)

    def minimum(self, o):
        return _binary_fn("minimum", self, o)

    def clamp(self, min=None, max=None):  # noqa: A002 (torch's names)
        if min is None and max is None:
            raise ValueError("clamp needs min or max")
        bounds = tuple(None if b is None else _operand(b) for b in (min, max))
        if any(isinstance(b, Sym) for b in bounds):
            # tensor bounds: NaN in x or in a bound gives NaN, as torch
            return Sym("clampt", (_as_float(self),) + bounds)
        return Sym("clamp", (_as_float(self),) + bounds)

    def to(self, dtype, *args, **kwargs):
        if args or kwargs or dtype not in (torch.float32, torch.int32) or (
                dtype is torch.int32 and self.kind != "i"):
            raise NotImplementedError(
                f"op 'to' with {dtype!r}: only .to(torch.float32) (and "
                ".to(torch.int32) of an int32 value) is supported in a model "
                "compiled into the generic kernels")
        return _as_float(self) if dtype is torch.float32 else self

    def float(self):
        return _as_float(self)


def _supported():
    return (list(_ARITH_C) + ["neg", "pow", "remainder (int32)"]
            + list(_COMPARE_C) + ["to(float32)", "float"]
            + sorted(_TORCH_FUNCS.values()))


def _operand(v):
    if isinstance(v, Sym):
        return _as_float(v)
    if _is_number(v):
        return _number(v)
    raise TypeError(f"unsupported operand {type(v).__name__} in a traced "
                    "model")


def _as_float(v):
    """A boolean or int32 node promoted to float32, as PyTorch promotes
    it against a float."""
    if isinstance(v, Sym) and v.kind == "b":
        return Sym("tofloat", (v,))
    if isinstance(v, Sym) and v.kind == "i":
        return Sym("itof", (v,))
    return v


def _arith(op, a, b):
    """``a op b`` with PyTorch's promotion: int32 with an integer stays
    int32 (but ``/`` divides in float32), anything with a float is
    float32."""
    if not (isinstance(a, Sym) or isinstance(b, Sym)):
        return NotImplemented
    try:
        if op != "div" and _is_int(a) and _is_int(b):
            return Sym(op, (_int_operand(a), _int_operand(b)), kind="i")
        return Sym(op, (_operand(a), _operand(b)))
    except TypeError:
        return NotImplemented


def _mod(a, b):
    """``a % b`` of int32 values, with Python's sign rule as PyTorch's
    ``remainder``."""
    if not (_is_int(a) and _is_int(b)):
        raise NotImplementedError(
            "op 'remainder' is supported only between int32 values (the "
            "step index t and integers) in a model compiled into the "
            "generic kernels")
    return Sym("mod", (_int_operand(a), _int_operand(b)), kind="i")


def _compare(op, a, b):
    try:
        if _is_int(a) and _is_int(b):
            return Sym(op, (_int_operand(a), _int_operand(b)), kind="b")
        return Sym(op, (_operand(a), _operand(b)), kind="b")
    except TypeError:
        return NotImplemented


def _logic(op, a, b):
    _prior_only(op)
    if not all(isinstance(v, Sym) and v.kind == "b" for v in (a, b)):
        raise NotImplementedError(
            f"op '{op}' is supported only between booleans in a model "
            "compiled into the generic kernels")
    return Sym(op, (a, b), kind="b")


def _unary(name, a):
    if not isinstance(a, Sym):
        raise TypeError(f"{name} of a non-traced value in a traced model")
    return Sym(name, (_as_float(a),))


def _binary_fn(name, a, b):
    if not (isinstance(a, Sym) and isinstance(b, Sym)):
        raise TypeError(f"torch.{name} takes two tensors")
    return Sym(name, (_as_float(a), _as_float(b)))


def _where(cond, a, b):
    if not (isinstance(cond, Sym) and cond.kind == "b"):
        raise NotImplementedError(
            "torch.where needs a traced boolean condition")
    if _is_int(a) and _is_int(b):
        return Sym("where", (cond, _int_operand(a), _int_operand(b)),
                   kind="i")
    return Sym("where", (cond, _operand(a), _operand(b)))


# ---------------------------------------------------------------------------
# evaluation on tensors (the recorded graph, for the tests)
# ---------------------------------------------------------------------------

def evaluate(node, env):
    """Evaluate a recorded graph on tensors: ``env`` maps the leaves,
    ``{"theta": [..], "noise": t, "x": t, "m": [..]}``. Each node runs
    the PyTorch op the user's callable ran, so the result equals the
    callable's bit for bit."""
    memo = {}

    def ev(v):
        if not isinstance(v, Sym):
            return v
        key = id(v)
        if key not in memo:
            memo[key] = _eval_node(v, [ev(a) for a in v.args], env)
        return memo[key]

    return ev(node)


def _eval_node(v, a, env):
    op = v.op
    if op in ("theta", "m", "xs", "obs"):
        return env[op][a[0]]
    if op in ("noise", "x", "t"):
        return env[op]
    if op in _ARITH_C or op in _COMPARE_C or op == "mod":
        return getattr(operator, "truediv" if op == "div" else op)(a[0], a[1])
    if op == "rdiv":
        return a[1] / a[0]
    if op == "neg":
        return -a[0]
    if op in ("pow", "powf"):
        return a[0] ** a[1]
    if op in ("and", "or"):
        return a[0] & a[1] if op == "and" else a[0] | a[1]
    if op == "not":
        return ~a[0]
    if op == "i0e":
        return D.i0e(a[0])
    if op in ("tofloat", "itof"):
        return a[0].to(torch.float32)
    if op == "where":
        return torch.where(*a)
    if op == "clamp":
        return torch.clamp(a[0], min=a[1], max=a[2])
    if op == "clampt":
        def bound(b):
            return b if b is None or torch.is_tensor(b) else \
                torch.full_like(a[0], b)
        return torch.clamp(a[0], min=bound(a[1]), max=bound(a[2]))
    return getattr(torch, op)(*a)


# ---------------------------------------------------------------------------
# emission
# ---------------------------------------------------------------------------

def f32_literal(value) -> str:
    """A float32 constant as its exact bit pattern."""
    bits = int(np.array(value, np.float32).view(np.uint32))
    return f"__uint_as_float(0x{bits:08x}u)"


def _topo(out):
    """The graph's nodes, each after its operands."""
    order, seen = [], set()

    def visit(v):
        if not isinstance(v, Sym) or id(v) in seen:
            return
        seen.add(id(v))
        for a in v.args:
            visit(a)
        order.append(v)

    visit(out)
    return order


def _pow_expr(x, p):
    if p == 0:
        return "1.0f"
    if p == 1:
        return x
    if p == 2:
        return f"({x} * {x})"
    if p == 3:
        return f"(({x} * {x}) * {x})"
    if p == -1:
        return f"(1.0f / {x})"
    if p == -2:
        return f"(1.0f / ({x} * {x}))"
    return f"powf({x}, {float(p)!r}f)"


def _pow_ops(p):
    return {0: 0, 1: 0, 2: 1, 3: 2, -1: 1, -2: 2}.get(p, 1)


# kt_i0e: 18 Chebyshev steps of three operations and four more (|x| <= 8)
_OPS = {"clamp": 2, "clampt": 2, "tofloat": 0, "ones_like": 0,
        "zeros_like": 0, "i0e": 58}


def _node_expr(v, name):
    """C expression of one node, its operands named by ``name``."""
    a = [name(x) if isinstance(x, Sym) else x for x in v.args]

    def lit(x):   # an int32 node's constants are Python ints
        if isinstance(x, str):
            return x
        return str(x) if isinstance(x, int) else f32_literal(x)

    op = v.op
    if op == "div" and not isinstance(a[1], str):   # x * (1/c), as torch
        inv = np.float32(1.0) / np.float32(a[1])
        return f"({lit(a[0])} * {f32_literal(inv)})"
    if op in _ARITH_C:
        return f"({lit(a[0])} {_ARITH_C[op]} {lit(a[1])})"
    if op == "mod":
        return f"kt_imod({lit(a[0])}, {lit(a[1])})"
    if op == "itof":
        return f"((float)({a[0]}))"
    if op in _COMPARE_C:
        return f"({lit(a[0])} {_COMPARE_C[op]} {lit(a[1])})"
    if op == "rdiv":
        return f"((1.0f / {a[0]}) * {lit(a[1])})"
    if op == "neg":
        return f"(-{a[0]})"
    if op == "pow":
        return _pow_expr(a[0], v.args[1])
    if op == "powf":   # torch's pow_tensor_scalar: sqrt at 0.5, else pow
        p = v.args[1]
        if p == 0.5:
            return f"sqrtf({a[0]})"
        return f"powf({a[0]}, {f32_literal(p)})"
    if op in ("and", "or"):
        return f"({a[0]} {'&&' if op == 'and' else '||'} {a[1]})"
    if op == "not":
        return f"(!{a[0]})"
    if op in _UNARY_C:
        return f"{_UNARY_C[op]}({a[0]})"
    if op == "square":
        return f"({a[0]} * {a[0]})"
    if op == "tofloat":
        return f"({a[0]} ? 1.0f : 0.0f)"
    if op == "where":
        return f"({a[0]} ? {lit(a[1])} : {lit(a[2])})"
    if op == "hypot":
        return f"hypotf({a[0]}, {a[1]})"
    if op in ("maximum", "minimum"):
        # NaN propagates, as torch.maximum / torch.minimum
        fn = "fmaxf" if op == "maximum" else "fminf"
        return (f"(({a[0]} != {a[0]} || {a[1]} != {a[1]}) ? "
                f"({a[0]} + {a[1]}) : {fn}({a[0]}, {a[1]}))")
    if op == "clamp":
        x = a[0]
        if a[1] is not None:
            x = f"fmaxf({x}, {lit(a[1])})"
        if a[2] is not None:
            x = f"fminf({x}, {lit(a[2])})"
        return f"({a[0]} != {a[0]} ? {a[0]} : {x})"
    if op == "clampt":
        x, nan_first = a[0], [a[0]]
        if a[1] is not None:
            x = f"fmaxf({x}, {lit(a[1])})"
            nan_first.append(lit(a[1]))
        if a[2] is not None:
            x = f"fminf({x}, {lit(a[2])})"
            nan_first.append(lit(a[2]))
        for y in reversed(nan_first):   # NaN of x, then of min, then max
            x = f"({y} != {y} ? {y} : {x})"
        return x
    if op in ("ones_like", "zeros_like"):
        return "1.0f" if op == "ones_like" else "0.0f"
    raise NotImplementedError(f"op {op!r} cannot be emitted")


_LEAF_C = {"theta": "th[{}]", "m": "m[{}]", "noise": "e", "x": "x",
           "xs": "x[{}]", "t": "t", "obs": "obs[{}]"}
_CTYPE = {"f": "float", "b": "bool", "i": "int"}


def _emit_body(outs, prefix="v"):
    """SSA lines computing every graph of ``outs`` (shared nodes once),
    their names ``{prefix}0``, ``{prefix}1``, ... Returns (lines, C
    expression of each output, operations)."""
    names, lines, ops, seen = {}, [], 0, set()
    for out in outs:
        for v in _topo(out):
            if id(v) in seen:
                continue
            seen.add(id(v))
            if v.op in _LEAF_C:
                names[id(v)] = _LEAF_C[v.op].format(*v.args)
                continue
            expr = _node_expr(v, lambda x: names[id(x)])
            name = f"{prefix}{len(lines)}"
            names[id(v)] = name
            lines.append(f"  const {_CTYPE[v.kind]} {name} = {expr};")
            ops += _pow_ops(v.args[1]) if v.op == "pow" else _OPS.get(v.op, 1)
    exprs = [names[id(o)] if isinstance(o, Sym) else f32_literal(o)
             for o in outs]
    return lines, exprs, ops


def emit_function(fname, params, out):
    """One ``__device__ __forceinline__ float fname(params)`` returning
    the graph ``out``. Returns (C text, float operations per call)."""
    lines, (expr,), ops = _emit_body([_as_float(out)])
    body = "".join(line + "\n" for line in lines)
    return (f"__device__ __forceinline__ float {fname}({params}) {{\n"
            f"{body}  return {expr};\n}}\n", ops)


def emit_outputs(fname, params, outs, out_name):
    """One ``__device__ __forceinline__ void fname(params)`` writing the
    float32 graphs ``outs`` to ``out_name[0..]``, computed from the
    inputs before any is written. Returns (C text, operations)."""
    lines, exprs, ops = _emit_body([_as_float(o) for o in outs])
    stores = "".join(f"  {out_name}[{j}] = {e};\n"
                     for j, e in enumerate(exprs))
    body = "".join(line + "\n" for line in lines)
    return (f"__device__ __forceinline__ void {fname}({params}) {{\n"
            f"{body}{stores}}}\n", ops)


# ---------------------------------------------------------------------------
# tracing the user's callables
# ---------------------------------------------------------------------------

def theta_args(structure):
    """Traced theta: one leaf (``structure=None``) or a tuple of K."""
    if structure is None:
        return Sym("theta", (0,))
    return tuple(Sym("theta", (k,)) for k in range(structure))


def _check_out(out, what):
    if not (isinstance(out, Sym) or _is_number(out)):
        raise TypeError(f"{what} returned {type(out).__name__}, not a "
                        "scalar expression")
    if isinstance(out, Sym) and out.kind == "b":
        return _as_float(out)
    return out


def trace_draw(draw, structure):
    return _check_out(draw(theta_args(structure), Sym("noise")), "draw")


def probe_structure(draw):
    """The theta structure ``draw`` accepts, when it is not known yet: a
    bare leaf, else the first tuple length from 1 to 16 that it
    unpacks or indexes without error. Raises the last error if none
    does (an unsupported op raises NotImplementedError at once)."""
    err = None
    for structure in (None,) + tuple(range(1, _MAX_ARGS + 1)):
        try:
            trace_draw(draw, structure)
            return structure
        except (TypeError, ValueError, IndexError) as e:
            err = e
    raise err


def trace_stats(stats, nmoments):
    """The per-draw summaries as graphs of ``x``: the stats, or the raw
    power chain x, x*x, (x*x)*x, ... of the TPU kernels."""
    x = Sym("x")
    if stats is not None:
        return tuple(_check_out(g(x), f"stats[{j}]")
                     for j, g in enumerate(stats))
    chain, xp = [], x
    for p in range(nmoments):
        chain.append(xp)
        if p + 1 < nmoments:
            xp = xp * x
    return tuple(chain)


def trace_loglike(loglike, structure):
    """The graph of a deterministic, elementwise ``loglike(theta)`` of
    the pushed parameters: data enter as Python or numpy constants (a
    Python loop over 8 data points traces to 8 terms); nothing random,
    nothing reduced over walkers."""
    return _check_out(loglike(theta_args(structure)), "loglike")


def trace_reduce(reduce_cost, structure, nstats):
    m = tuple(Sym("m", (j,)) for j in range(nstats))
    return _check_out(reduce_cost(theta_args(structure), m), "reduce_cost")


# ---------------------------------------------------------------------------
# the sequential (scan) model: init, step, observe
# ---------------------------------------------------------------------------

class ScanContractError(ValueError):
    """A scan model that breaks the contract whatever the theta
    structure: not retried by ``probe_scan``."""


def _state(out, what, nstate=None):
    """The flat state tuple of ``init``'s or ``step``'s output: one
    scalar, or a tuple or list of scalars."""
    leaves = list(out) if isinstance(out, (tuple, list)) else [out]
    if nstate is not None and len(leaves) != nstate:
        raise ScanContractError(
            f"{what} returned a state of {len(leaves)} leaves; init gives "
            f"{nstate}")
    return tuple(_check_out(v, f"{what} state leaf {j}")
                 for j, v in enumerate(leaves)), isinstance(out, (tuple,
                                                                 list))


def default_observe(nmoments):
    """The raw moments ``x, x*x, (x*x)*x, ...`` of a scalar state
    (pallas_kernels.py:2881-2887)."""
    def observe(theta, x, t, obs):   # noqa: ARG001
        vals, xp = [], x
        for p in range(nmoments):
            vals.append(xp)
            if p + 1 < nmoments:
                xp = xp * x
        return tuple(vals)
    return observe


@dataclass(frozen=True)
class ScanGraphs:
    """The traced scan model: the state's leaves after ``init`` and after
    one ``step``, and the observations of the stepped state."""
    structure: object
    init: tuple
    step: tuple
    observe: tuple
    state_is_tuple: bool


def trace_scan(step, init, observe, structure, series_tree=None):
    """Trace ``init(theta)``, ``step(theta, x, eps, t)`` and ``observe(
    theta, x, t, obs)`` for a theta structure (None: one leaf; K: a tuple
    of K). ``observe`` reads the state after the step, so it is traced on
    the state's own leaves."""
    theta = theta_args(structure)
    x0, is_tuple = _state(init(theta), "init")
    xs = tuple(Sym("xs", (j,)) for j in range(len(x0)))
    state = xs if is_tuple else xs[0]
    t = Sym("t", kind="i")
    x1, _ = _state(step(theta, state, Sym("noise"), t), "step", len(x0))
    obs = None if series_tree is None else series_tree(
        [Sym("obs", (j,)) for j in range(series_tree.nleaves)])
    vals = observe(theta, state, t, obs)
    if not isinstance(vals, tuple) or not 1 <= len(vals) <= 16:
        raise ScanContractError(
            "observe must return a tuple of 1..16 values, got "
            f"{type(vals).__name__}")
    vals = tuple(_check_out(v, f"observe[{j}]") for j, v in enumerate(vals))
    return ScanGraphs(structure, x0, x1, vals, is_tuple)


def probe_scan(step, init, observe, series_tree=None):
    """``trace_scan`` for the first theta structure, from one leaf to a
    16-tuple, that the model accepts. A broken contract raises at once;
    else the last structure's error is raised if none fits."""
    err = None
    for k in (None,) + tuple(range(1, _MAX_ARGS + 1)):
        try:
            return trace_scan(step, init, observe, k, series_tree)
        except ScanContractError:
            raise
        except (TypeError, ValueError, IndexError) as e:
            err = e
    raise err


_IMOD = """__device__ __forceinline__ int kt_imod(int a, int b) {
  const int r = a % b;   // the sign of b, as torch.remainder
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}
"""


@dataclass(frozen=True)
class GeneratedScan:
    """The emitted scan model: ``functions`` (the device functions alone,
    for the host-compiler test), ``source`` (the translation unit ending
    in ``#include "scan.cuh"``), and operation counts per walker
    (``init_ops``) and per step (``step_ops``, ``observe_ops``)."""
    functions: str
    source: str
    nparams: int
    nstate: int
    nstats: int
    nseries: int
    init_ops: int
    step_ops: int
    observe_ops: int


def generate_scan(graphs, *, nseries, noise):
    """Emit the translation unit of a traced scan model:

        void scan_init(const float* th, float* x);
        void scan_step(const float* th, const float* x, float e, int t,
                       float* xn);
        void scan_observe(const float* th, const float* x, int t,
                          const float* obs, float* o);
    """
    s = graphs.structure
    nparams = 1 if s is None else s
    init_fn, init_ops = emit_outputs(
        "scan_init", "const float* th, float* x", graphs.init, "x")
    step_fn, step_ops = emit_outputs(
        "scan_step", "const float* th, const float* x, float e, int t, "
        "float* xn", graphs.step, "xn")
    obs_fn, observe_ops = emit_outputs(
        "scan_observe", "const float* th, const float* x, int t, "
        "const float* obs, float* o", graphs.observe, "o")
    functions = "\n".join([_IMOD, init_fn, step_fn, obs_fn])
    source = "\n".join([
        "// Generated by kissabc_tpu_torch/ops/codegen.py from a user scan "
        "model.",
        f"#define KT_NPARAMS {nparams}",
        f"#define KT_NSTATE {len(graphs.init)}",
        f"#define KT_NSTATS {len(graphs.observe)}",
        f"#define KT_NSERIES {nseries}",
        f"#define KT_NOISE_NORMAL {int(noise == 'normal')}",
        '#include "common.cuh"',
        "namespace {",
        functions,
        "}  // namespace",
        '#include "scan.cuh"', ""])
    return GeneratedScan(functions, source, nparams, len(graphs.init),
                         len(graphs.observe), nseries, init_ops, step_ops,
                         observe_ops)


# ---------------------------------------------------------------------------
# the prior, from a per-family table
# ---------------------------------------------------------------------------

_NEG_INF_C = "__uint_as_float(0xff800000u)"

# families whose entry is their own logpdf, traced on one theta leaf: the
# port's float32 formula, op for op, on its float32 host constants (a
# division by a constant a multiply by its float32 reciprocal, as PyTorch
# divides a CUDA tensor by a scalar). The discrete ones read the pushed
# (rounded) value. Hypergeometric's logpdf is a host table; its entry is
# the closed form ``logpdf_closed``, equal to the table at the integers.
_TRACED = (
    D.Exponential, D.Gamma, D.LogUniform, D.BetaPrime, D.StudentT, D.Beta,
    D.LogNormal, D.Laplace, D.Cauchy, D.Weibull, D.Chisq, D.FDist,
    D.Logistic, D.Rayleigh, D.Pareto, D.InverseGamma, D.Gumbel,
    D.TriangularDist, D.Arcsine, D.Semicircle, D.Frechet, D.Levy,
    D.GeneralizedPareto, D.Kumaraswamy, D.VonMises, D.SymTriangularDist,
    D.Cosine, D.Epanechnikov, D.Biweight, D.Triweight, D.JohnsonSU,
    D.GeneralizedExtremeValue, D.InverseGaussian, D.Chi,
    D.PGeneralizedGaussian, D.Rician, D.Lindley, D.LogitNormal,
    D.Poisson, D.Bernoulli, D.Binomial, D.Geometric, D.NegativeBinomial,
    D.BetaBinomial, D.Hypergeometric)
# the first entries, written out (their division by sigma divides, so the
# kernels keep the bits they had before the traced entries)
_WRITTEN = (D.Uniform, D.Normal, D.DiscreteUniform)


def _missing_entry(d, top=True):
    """The family of ``d`` (or of a base or component inside it) that has
    no entry in the prior table, or None. ``Dirac`` has one as a marginal
    of its own: its push is the atom, not a rounding."""
    kind = type(d)
    if kind in _WRITTEN or kind in _TRACED or (kind is D.Dirac and top):
        return None
    if kind in (D.Truncated, D.Affine):
        return _missing_entry(d.base, False)
    if kind is D.Mixture:
        for c in d.components:
            missing = _missing_entry(c, False)
            if missing is not None:
                return missing
        return None
    return kind.__name__


def _written_logpdf(d, x):
    """(C expression, operations) of an entry written out: Uniform,
    Normal, DiscreteUniform and Truncated of the first two."""
    kind = type(d)
    if kind is D.Uniform:
        return (f"(({x} >= {f32_literal(d.a)}) && ({x} <= {f32_literal(d.b)}))"
                f" ? {f32_literal(-d._nll)} : {_NEG_INF_C}", 3)
    if kind is D.Normal:
        z = f"(({x} - {f32_literal(d.mu)}) / {f32_literal(d.sigma)})"
        return (f"((-0.5f * {z}) * {z} - {f32_literal(d._lnorm)})", 6)
    if kind is D.DiscreteUniform:   # on the pushed (rounded) value
        return (f"(({x} >= {f32_literal(d.a)}) && ({x} <= {f32_literal(d.b)}))"
                f" ? {f32_literal(-d._lpmf)} : {_NEG_INF_C}", 3)
    base, ops = _written_logpdf(d.base, x)   # Truncated
    return (f"((({x} >= {f32_literal(d.lo)}) && ({x} <= "
            f"{f32_literal(d.hi)})) ? (({base}) - {f32_literal(d._lz)})"
            f" : {_NEG_INF_C})", ops + 4)


def _marginal_logpdf(d, k):
    """(SSA lines, C expression, operations) of marginal ``k``'s logpdf
    at ``th[k]``: the formula of ``kissabc_tpu_torch/distributions.py``
    with its float32 host constants. Truncated, Affine and Mixture take
    any base or components that have entries; a family without one
    raises ``NotImplementedError`` naming it."""
    missing = _missing_entry(d)
    if missing is not None:
        raise NotImplementedError(
            f"{missing} has no entry in the generic kernels' prior table "
            f"(marginal {k}, {d!r}): its push and logpdf cannot be compiled "
            "into the fused sweep (refused as the JAX kernels refuse "
            "them, whose pallas_call \"captures constants\" for their host "
            "tables: Skellam, NoncentralChisq, PoissonBinomial, Categorical, "
            "DiscreteNonParametric and TruncatedDiscrete; a vector or matrix "
            "family is refused as the JAX kernels refuse it: they take only "
            "[n] leaves)")
    x = f"th[{k}]"
    if type(d) is D.Dirac:   # on the pushed value: 0 at the atom
        return [], f"(({x} == {_dirac_atom(d)}) ? 0.0f : {_NEG_INF_C})", 2
    if type(d) in _WRITTEN or (type(d) is D.Truncated
                               and type(d.base) in (D.Uniform, D.Normal)):
        expr, ops = _written_logpdf(d, x)
        return [], expr, ops
    lines, (expr,), ops = _emit_body([trace_marginal(d, k)],
                                     prefix=f"p{k}_")
    return lines, expr, ops


def trace_marginal(d, k=0):
    """The graph of a traced entry: ``d``'s logpdf (Hypergeometric's
    ``logpdf_closed``) recorded on theta leaf ``k``; ``evaluate`` runs it
    on tensors, the same PyTorch ops as the logpdf."""
    logpdf = (d.logpdf_closed if type(d) is D.Hypergeometric
              else d.logpdf)
    _tracing_prior[0] = True
    try:
        return _as_float(_operand(logpdf(Sym("theta", (k,)))))
    finally:
        _tracing_prior[0] = False


def _dirac_atom(d):
    """The C literal of a ``Dirac``'s atom as its push gives it: an
    integer atom through int32, else float32, then float."""
    atom = np.int32(d.value) if d._isint else np.float32(d.value)
    return f32_literal(float(np.float32(atom)))


def _push_line(d, k):
    """(``prior_push``'s line for marginal ``k``, operations): a
    ``Dirac`` sets its atom, another discrete marginal rounds half to
    even, a continuous one is copied."""
    if type(d) is D.Dirac:
        return f"  out[{k}] = {_dirac_atom(d)};", 0
    if d.discrete:
        return f"  out[{k}] = rintf(th[{k}]);", 1
    return f"  out[{k}] = th[{k}];", 0


def prior_marginals(prior):
    """(marginals, structure): a ``Factored`` prior's marginals and K,
    or one univariate prior and ``None``."""
    if isinstance(prior, D.Factored):
        return prior.p, prior.nparams
    return (prior,), None


def emit_prior(prior):
    """``prior_logpdf(th)``, the sum of the marginals' logpdfs in
    ``Factored.logpdf``'s order, and ``prior_push(th, out)``, which
    rounds the discrete marginals half to even (``rintf``, then float,
    as the JAX kernels' ``push_tree`` and re-cast), sets a ``Dirac``
    marginal to its atom and copies the continuous ones. Every sweep evaluates the prior on the pushed
    values. Returns (C text, logpdf operations, push operations)."""
    marginals, _ = prior_marginals(prior)
    lines, pushes, ops, push_ops = [], [], 0, 0
    for k, d in enumerate(marginals):
        if d.event_dim:
            raise NotImplementedError(
                f"marginal {k} ({d!r}) is not a scalar: the generic "
                "kernels, as the JAX package's, take only per-walker scalar "
                "parameters ([n] leaves)")
        body, expr, n = _marginal_logpdf(d, k)
        ops += n + (k > 0)
        lines += body
        lines.append(f"  lp = {expr};" if k == 0
                     else f"  lp = lp + ({expr});")
        line, n = _push_line(d, k)
        pushes.append(line)
        push_ops += n
    body = "\n".join(lines)
    text = ("__device__ __forceinline__ float prior_logpdf(const float* th) "
            f"{{\n  float lp;\n{body}\n  return lp;\n}}\n"
            "__device__ __forceinline__ void prior_push(const float* th,"
            " float* out) {\n" + "\n".join(pushes) + "\n}\n")
    return text, ops, push_ops


# ---------------------------------------------------------------------------
# one model -> one translation unit
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Generated:
    """The emitted model: ``functions`` (the device functions alone, for
    the host-compiler test), ``source`` (the translation unit: macros,
    functions and ``#include "generic.cuh"``), and operation counts per
    draw (draw and summaries) and per walker (reduce_cost and prior)."""
    functions: str
    source: str
    nparams: int
    nstats: int
    draw_ops: int
    stat_ops: int
    reduce_ops: int
    prior_ops: int
    push_ops: int = 0


def generate(draw, *, structure, nstats, stats, nmoments, noise,
             reduce_cost=None, prior=None, ais=False, abcde=False):
    """Trace the model and emit its translation unit. ``structure``:
    None for one theta leaf, else the tuple length K. With
    ``reduce_cost`` and ``prior`` the unit also holds the fused smc
    sweep, or with ``ais=True`` the fused AIS sweep instead, or with
    ``abcde=True`` the fused ABC-DE generation (each pushes discrete
    marginals)."""
    nparams = 1 if structure is None else structure
    draw_fn, draw_ops = emit_function(
        "draw", "const float* th, float e", trace_draw(draw, structure))
    fns, stat_ops = [draw_fn], 0
    for j, g in enumerate(trace_stats(stats, nmoments)):
        text, n = emit_function(f"stat_{j}", "float x", g)
        fns.append(text)
        stat_ops += n
    calls = "\n".join(f"  g[{j}] = stat_{j}(x);" for j in range(nstats))
    fns.append("__device__ __forceinline__ void stats_of(float x, float* g) "
               f"{{\n{calls}\n}}\n")
    reduce_ops = prior_ops = push_ops = 0
    if reduce_cost is not None:
        text, reduce_ops = emit_function(
            "reduce_cost", "const float* th, const float* m",
            trace_reduce(reduce_cost, structure, nstats))
        fns.append(text)
        text, prior_ops, push_ops = emit_prior(prior)
        fns.append(text)
    functions = "\n".join(fns)
    source = "\n".join([
        "// Generated by kissabc_tpu_torch/ops/codegen.py from a user model.",
        f"#define KT_NPARAMS {nparams}",
        f"#define KT_NSTATS {nstats}",
        f"#define KT_NOISE_NORMAL {int(noise == 'normal')}",
        "#define KT_HAS_SWEEP "
        f"{int(reduce_cost is not None and not (ais or abcde))}",
        *(["#define KT_HAS_AIS 1"] if ais else []),
        *(["#define KT_HAS_ABCDE 1"] if abcde else []),
        '#include "common.cuh"',
        "namespace {",
        functions,
        "}  // namespace",
        '#include "generic.cuh"', ""])
    return Generated(functions, source, nparams, nstats, draw_ops, stat_ops,
                     reduce_ops, prior_ops, push_ops)


@dataclass(frozen=True)
class GeneratedTempered:
    """The emitted tempered model: ``functions`` (the device functions
    alone, for the host-compiler test), ``source`` (the translation unit
    ending in ``#include "tempered.cuh"``), and operation counts per
    walker of the log-likelihood, the prior's logpdf and its push."""
    functions: str
    source: str
    nparams: int
    loglike_ops: int
    prior_ops: int
    push_ops: int


def generate_tempered(loglike, prior):
    """Trace ``loglike`` on the prior's theta structure and emit the
    translation unit of the tempered sweep:

        float loglike(const float* th);
        float prior_logpdf(const float* th);
        void prior_push(const float* th, float* out);
    """
    structure = prior_marginals(prior)[1]
    nparams = 1 if structure is None else structure
    ll_fn, loglike_ops = emit_function(
        "loglike", "const float* th", trace_loglike(loglike, structure))
    prior_fn, prior_ops, push_ops = emit_prior(prior)
    functions = "\n".join([ll_fn, prior_fn])
    source = "\n".join([
        "// Generated by kissabc_tpu_torch/ops/codegen.py from a user "
        "log-likelihood.",
        f"#define KT_NPARAMS {nparams}",
        '#include "common.cuh"',
        "namespace {",
        functions,
        "}  // namespace",
        '#include "tempered.cuh"', ""])
    return GeneratedTempered(functions, source, nparams, loglike_ops,
                             prior_ops, push_ops)
