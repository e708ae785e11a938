"""The port's copy of the optax pieces the training loop builds
(``tpu_p2p/train.py:243-261``): ``chain``, ``clip_by_global_norm``,
``sgd``, ``adamw`` (``scale_by_adam`` → ``add_decayed_weights`` →
``scale_by_learning_rate``), the ``constant``, ``linear``, ``join`` and
``warmup_cosine_decay`` schedules, and ``apply_updates``.

A transformation is ``init(params) → state`` and ``update(updates,
state, params) → (updates, state)`` over dicts of tensors (a rank's
param shards: every update is elementwise, so a moment is shaped like
its shard). A state is a nested tuple of NamedTuples and dicts laid out
as optax lays it out, so :func:`leaf_paths` gives the strings
``jax.tree_util.keystr`` gives for optax's state (``[1][0].mu['wq']``),
and :func:`tree_leaves` its leaf order (dict keys sorted): the
checkpoint stores the leaves in that order and checks the paths.

The arithmetic is optax 0.2.6's under JAX's promotion rules:

- a Python constant takes the dtype of the tensor it meets (JAX's weak
  typing): it is rounded to that dtype first, so it enters as a 0-dim
  tensor of that dtype, never as a Python scalar (which torch would
  keep at full precision inside a bf16 op);
- the moments take the param dtype; ``count`` is an int32 scalar, kept
  on the host, so the schedules and the bias corrections are computed
  there in float32 (``1 - b**count``, then cast to the moment's dtype)
  and no step waits for the device;
- a schedule reads the count before the increment;
- :func:`apply_updates` adds ``p + u`` in the param dtype (no float32
  widening, unlike the plain SGD step's update).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, NamedTuple, Tuple, Union

import torch

Tree = object
Schedule = Callable[[torch.Tensor], Union[float, torch.Tensor]]
ScalarOrSchedule = Union[float, Schedule]

_INT32_MAX = 2**31 - 1


# ------------------------------------------------------------- states


class EmptyState(NamedTuple):
    """A transformation without state (optax's ``EmptyState``)."""


class ScaleByAdamState(NamedTuple):
    count: torch.Tensor     # int32 scalar, on the host
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


class ScaleByScheduleState(NamedTuple):
    count: torch.Tensor     # int32 scalar, on the host


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


# ------------------------------------------------------- tree helpers


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_flatten_with_path(tree: Tree, prefix: str = ""
                           ) -> List[Tuple[str, object]]:
    """``[(keystr, leaf), ...]`` in JAX's flatten order: dict keys
    sorted, NamedTuple fields in order, sequences by index; ``None`` has
    no leaf. The key strings are ``jax.tree_util.keystr``'s."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += tree_flatten_with_path(tree[k], f"{prefix}[{k!r}]")
        return out
    if _is_namedtuple(tree):
        out = []
        for name in tree._fields:
            out += tree_flatten_with_path(getattr(tree, name),
                                          f"{prefix}.{name}")
        return out
    if isinstance(tree, (tuple, list)):
        out = []
        for i, v in enumerate(tree):
            out += tree_flatten_with_path(v, f"{prefix}[{i}]")
        return out
    return [(prefix, tree)]


def tree_leaves(tree: Tree) -> list:
    return [v for _, v in tree_flatten_with_path(tree)]


def leaf_paths(tree: Tree) -> List[str]:
    """Each leaf's ``keystr``, in flatten order (the checkpoint's
    pairing fingerprint)."""
    return [p for p, _ in tree_flatten_with_path(tree)]


def tree_unflatten(template: Tree, leaves: list) -> Tree:
    """``template``'s structure with ``leaves`` in flatten order."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if _is_namedtuple(t):
            return type(t)(*(build(getattr(t, n)) for n in t._fields))
        if isinstance(t, (tuple, list)):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def tree_map_leaves(fn, tree: Tree) -> Tree:
    """``tree`` with ``fn(path, leaf)`` for each leaf."""
    flat = tree_flatten_with_path(tree)
    return tree_unflatten(tree, [fn(p, v) for p, v in flat])


# ------------------------------------------------------ the arithmetic


def _w(value, like: torch.Tensor) -> torch.Tensor:
    """A Python constant as JAX's weak typing enters it into an op with
    ``like``: rounded to ``like``'s dtype (a host 0-dim tensor)."""
    return torch.tensor(value, dtype=like.dtype)


def _f32(value) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32)


def _count() -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32)


def safe_increment(count: torch.Tensor) -> torch.Tensor:
    """``count + 1``, saturating at the int32 maximum."""
    return torch.where(count < _INT32_MAX, count + 1,
                       torch.tensor(_INT32_MAX, dtype=torch.int32))


# ---------------------------------------------------------- schedules


def constant_schedule(value: float) -> Schedule:
    return lambda count: value


def polynomial_schedule(init_value: float, end_value: float, power,
                        transition_steps: int,
                        transition_begin: int = 0) -> Schedule:
    if transition_steps <= 0:
        return lambda count: init_value
    transition_begin = max(transition_begin, 0)

    def schedule(count):
        c = torch.clamp(count - transition_begin, 0, transition_steps)
        frac = 1 - c.to(torch.float32) / _f32(transition_steps)
        if power != 1:
            frac = frac ** power
        return _f32(init_value - end_value) * frac + _f32(end_value)

    return schedule


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int,
                    transition_begin: int = 0) -> Schedule:
    return polynomial_schedule(init_value, end_value, 1, transition_steps,
                               transition_begin)


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0,
                          exponent: float = 1.0) -> Schedule:
    if not decay_steps > 0:
        raise ValueError("The cosine_decay_schedule requires positive "
                         f"decay_steps, got decay_steps={decay_steps}.")

    def schedule(count):
        ds = _f32(float(decay_steps))
        c = torch.minimum(count.to(torch.float32), ds)
        decayed = 0.5 * (1 + torch.cos(_f32(math.pi) * c / ds))
        if exponent != 1.0:
            decayed = decayed ** exponent
        if alpha:  # (1 - 0) * x + 0 is x
            decayed = _f32(1 - alpha) * decayed + _f32(alpha)
        return _f32(init_value) * decayed

    return schedule


def join_schedules(schedules, boundaries) -> Schedule:
    """``schedules[i]`` from ``boundaries[i-1]`` on, each fed the count
    since its boundary."""

    def schedule(count):
        out = schedules[0](count)
        for boundary, sched in zip(boundaries, schedules[1:]):
            nxt = sched(count - boundary)
            out = torch.where(count < boundary, _as_f32(out), _as_f32(nxt))
        return out

    return schedule


def _as_f32(v) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else _f32(v)


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0,
                                 exponent: float = 1.0) -> Schedule:
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    return join_schedules(
        [linear_schedule(init_value, peak_value, warmup_steps),
         cosine_decay_schedule(peak_value, decay_steps - warmup_steps,
                               alpha, exponent)],
        [warmup_steps])


# ---------------------------------------------------- transformations


def identity() -> GradientTransformation:
    return GradientTransformation(lambda params: EmptyState(),
                                  lambda u, state, params=None: (u, state))


def chain(*txs: GradientTransformation) -> GradientTransformation:
    """Apply ``txs`` in order; the state is the tuple of theirs."""

    def init(params):
        return tuple(tx.init(params) for tx in txs)

    def update(updates, state, params=None):
        if len(state) != len(txs):
            raise ValueError(f"chain of {len(txs)} transformations got a "
                             f"state of {len(state)}")
        new = []
        for tx, s in zip(txs, state):
            updates, s = tx.update(updates, s, params)
            new.append(s)
        return updates, tuple(new)

    return GradientTransformation(init, update)


def leaf_square_sums(updates: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """Each leaf's sum of squares, accumulated in float32 (``jnp.sum``
    of a bf16 array reduces in float32)."""
    return {k: torch.sum(g * g, dtype=torch.float32)
            for k, g in updates.items()}


def global_norm(sums: Dict[str, torch.Tensor],
                dtypes: Dict[str, torch.dtype]) -> torch.Tensor:
    """optax's ``sqrt(sum(jnp.sum(g**2) for g in leaves))`` from the
    leaves' float32 sums: each rounded to its leaf's dtype, then added
    in flatten order (a Python ``sum``, under JAX's promotion)."""
    total = None
    for k in sorted(sums):
        s = sums[k].to(dtypes[k])
        total = s if total is None else total + s
    return torch.sqrt(total)


def clip_by_global_norm(max_norm: float, reduce=None
                        ) -> GradientTransformation:
    """Scale the updates by ``max_norm / norm`` where their global norm
    exceeds ``max_norm`` (optax's ``where(norm < max_norm, g, g / norm *
    max_norm)``). ``reduce(sums)``: sum each leaf's float32 sum of
    squares over the ranks that hold its other shards, in place, so
    every rank gets the same norm (None: the updates are whole)."""

    def update(updates, state, params=None):
        sums = leaf_square_sums(updates)
        if reduce is not None:
            reduce(sums)
        g_norm = global_norm(sums, {k: g.dtype for k, g in updates.items()})
        trigger = g_norm < _w(max_norm, g_norm)
        out = {}
        for k, t in updates.items():
            clipped = (t / g_norm.to(t.dtype)) * _w(max_norm, t)
            out[k] = torch.where(trigger, t, clipped)
        return out, state

    return GradientTransformation(lambda params: EmptyState(), update)


def _bias_correction(decay: float, count: torch.Tensor) -> torch.Tensor:
    """``1 - decay**count`` in float32 (``count`` an int32 scalar)."""
    return 1 - _f32(decay) ** count.to(torch.float32)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                  eps_root: float = 0.0) -> GradientTransformation:
    """optax's ``scale_by_adam`` (no Nesterov, moments in the param
    dtype): ``m / (sqrt(v + eps_root) + eps)`` of the bias-corrected
    moments."""

    def init(params):
        return ScaleByAdamState(
            count=_count(),
            mu={k: torch.zeros_like(p) for k, p in params.items()},
            nu={k: torch.zeros_like(p) for k, p in params.items()})

    def update(updates, state, params=None):
        count_inc = safe_increment(state.count)
        bc1 = _bias_correction(b1, count_inc)
        bc2 = _bias_correction(b2, count_inc)
        out, mu, nu = {}, {}, {}
        for k, g in updates.items():
            m, v = state.mu[k], state.nu[k]
            m = _w(1 - b1, g) * g + _w(b1, m) * m
            v = _w(1 - b2, g) * (g * g) + _w(b2, v) * v
            m_hat = m / bc1.to(m.dtype)
            v_hat = v / bc2.to(v.dtype)
            out[k] = m_hat / (torch.sqrt(v_hat + _w(eps_root, v_hat))
                              + _w(eps, v_hat))
            mu[k], nu[k] = m, v
        return out, ScaleByAdamState(count=count_inc, mu=mu, nu=nu)

    return GradientTransformation(init, update)


def add_decayed_weights(weight_decay: float = 0.0
                        ) -> GradientTransformation:
    """``u + weight_decay * p`` (decoupled weight decay, after Adam's
    scaling and before the learning rate)."""

    def update(updates, state, params=None):
        if params is None:
            raise ValueError("add_decayed_weights needs the params")
        return ({k: u + _w(weight_decay, params[k]) * params[k]
                 for k, u in updates.items()}, state)

    return GradientTransformation(lambda params: EmptyState(), update)


def scale(step_size: float) -> GradientTransformation:
    def update(updates, state, params=None):
        return {k: _w(step_size, g) * g for k, g in updates.items()}, state

    return GradientTransformation(lambda params: EmptyState(), update)


def scale_by_schedule(step_size_fn: Schedule) -> GradientTransformation:
    def init(params):
        return ScaleByScheduleState(count=_count())

    def update(updates, state, params=None):
        step = step_size_fn(state.count)
        out = {}
        for k, g in updates.items():
            s = (step.to(g.dtype) if isinstance(step, torch.Tensor)
                 else _w(step, g))
            out[k] = s * g
        return out, ScaleByScheduleState(count=safe_increment(state.count))

    return GradientTransformation(init, update)


def scale_by_learning_rate(learning_rate: ScalarOrSchedule,
                           *, flip_sign: bool = True
                           ) -> GradientTransformation:
    m = -1 if flip_sign else 1
    if callable(learning_rate):
        return scale_by_schedule(lambda count: m * learning_rate(count))
    return scale(m * learning_rate)


def sgd(learning_rate: ScalarOrSchedule) -> GradientTransformation:
    """optax's ``sgd`` without momentum: ``chain(identity(),
    scale_by_learning_rate(lr))``."""
    return chain(identity(), scale_by_learning_rate(learning_rate))


def adamw(learning_rate: ScalarOrSchedule, b1: float = 0.9,
          b2: float = 0.999, eps: float = 1e-8, eps_root: float = 0.0,
          weight_decay: float = 1e-4) -> GradientTransformation:
    """optax's ``adamw`` (no mask, no Nesterov, ``mu_dtype`` None)."""
    return chain(scale_by_adam(b1, b2, eps, eps_root),
                 add_decayed_weights(weight_decay),
                 scale_by_learning_rate(learning_rate))


def apply_updates(params: Dict[str, torch.Tensor],
                  updates: Dict[str, torch.Tensor], *,
                  in_place: bool = False) -> Dict[str, torch.Tensor]:
    """``p + u`` in each param's dtype (optax's ``apply_updates``: no
    widening). ``in_place``: write into ``params`` and return it."""
    out = params if in_place else {}
    with torch.no_grad():
        for k, p in params.items():
            new = (p + updates[k]).to(p.dtype)
            if in_place:
                p.copy_(new)
            else:
                out[k] = new
    return out


def make_optimizer(optimizer: str, lr: float, *, steps: int,
                   weight_decay: float = 0.0, clip_norm: float = 0.0,
                   warmup_steps: int = 0, schedule: str = "constant",
                   clip_reduce=None) -> GradientTransformation:
    """The transformation ``tpu_p2p/train.py`` builds from its flags
    (``:246-261``): a warmup(+cosine) or constant learning rate, AdamW
    or SGD, and global-norm clipping first when ``clip_norm > 0``
    (``clip_reduce`` as :func:`clip_by_global_norm`'s ``reduce``)."""
    if schedule == "cosine":
        sched = warmup_cosine_decay_schedule(0.0, lr, warmup_steps,
                                             decay_steps=max(steps, 1))
    elif warmup_steps:
        sched = join_schedules([linear_schedule(0.0, lr, warmup_steps),
                                constant_schedule(lr)], [warmup_steps])
    else:
        sched = lr
    base = (adamw(sched, weight_decay=weight_decay)
            if optimizer == "adamw" else sgd(sched))
    return (chain(clip_by_global_norm(clip_norm, clip_reduce), base)
            if clip_norm > 0 else base)
