"""Optimizers as plain functions on tensor trees, in optax's shape: a
transformation is ``(init, update)``, ``update(updates, state, params)``
returns ``(updates, new_state)``, and the state is a tree of tuples whose
leaves come in a fixed order (:func:`tree_leaves`), so that a checkpoint
stores them as a flat list. Each definition is optax's (not
``torch.optim``'s): Adam's moments and bias correction, decoupled weight
decay on every leaf, the learning rate read at the step count before it is
incremented, global-norm clipping without an epsilon, and ``MultiSteps``'
running-mean accumulation. Trees are dicts (flattened in sorted key order,
as JAX flattens them), lists and tuples of tensors; the counts are int32
tensors beside the parameters, so no step reads a value back to the host.
"""

from __future__ import annotations

import math
from typing import Any, Callable, List, NamedTuple, Union

import torch

Schedule = Callable[[torch.Tensor], torch.Tensor]


class GradientTransformation(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Any]


class AdamState(NamedTuple):
    count: torch.Tensor     # int32 []
    mu: Any
    nu: Any


class ScheduleState(NamedTuple):
    count: torch.Tensor     # int32 []


class MultiStepsState(NamedTuple):
    mini_step: torch.Tensor      # int32 []
    gradient_step: torch.Tensor  # int32 []
    inner_opt_state: Any
    acc_grads: Any


# --- trees -----------------------------------------------------------------


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tree in JAX's order (dict keys sorted)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    if tree is None:
        return []
    raise TypeError(f"not a tensor tree leaf: {type(tree).__name__}")


def tree_unflatten(template, leaves):
    """``template``'s structure with its tensors replaced, in
    :func:`tree_leaves` order, by ``leaves``."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, torch.Tensor):
            return next(it)
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*[build(v) for v in node])
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return node

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template has")
    return out


def tree_map(fn, tree, *rest):
    """``fn`` over the tensors of ``tree`` (and of trees of its structure)."""
    leaves = [tree_leaves(t) for t in (tree,) + rest]
    return tree_unflatten(tree, [fn(*xs) for xs in zip(*leaves)])


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, summed leaf by leaf."""
    return torch.sqrt(sum(torch.sum(x * x) for x in tree_leaves(tree)))


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def _count(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)


# --- schedules (count -> learning rate, f32, on the count's device) ---------


def constant_schedule(value: float) -> Schedule:
    return lambda count: torch.full((), value, dtype=torch.float32, device=count.device)


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    if transition_steps <= 0:
        return constant_schedule(init_value)

    def schedule(count):
        frac = 1 - torch.clamp(count, 0, transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value
    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    if not decay_steps > 0:
        raise ValueError(f"cosine_decay_schedule requires positive decay_steps, got {decay_steps}")

    def schedule(count):
        count = torch.clamp_max(count.float(), float(decay_steps))
        cosine = 0.5 * (1 + torch.cos(math.pi * count / float(decay_steps)))
        return init_value * ((1 - alpha) * cosine + alpha)
    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0) -> Schedule:
    """Linear warmup from ``init_value`` to ``peak_value`` over
    ``warmup_steps``, then cosine decay to ``end_value`` at ``decay_steps``
    (optax's ``warmup_cosine_decay_schedule``)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warm = linear_schedule(init_value, peak_value, warmup_steps)
    decay = cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha)
    return lambda count: torch.where(count < warmup_steps, warm(count),
                                     decay(count - warmup_steps))


# --- transformations -------------------------------------------------------


def identity() -> GradientTransformation:
    return GradientTransformation(lambda params: (), lambda u, s, params=None: (u, s))


def chain(*txs: GradientTransformation) -> GradientTransformation:
    def init(params):
        return tuple(tx.init(params) for tx in txs)

    def update(updates, state, params=None):
        new_state = []
        for tx, s in zip(txs, state):
            updates, s = tx.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)
    return GradientTransformation(init, update)


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """Scale every update by max_norm / norm when the global norm reaches
    ``max_norm`` (``(t / norm) * max_norm``); leave them as they are below."""
    def update(updates, state, params=None):
        g_norm = global_norm(updates)
        keep = g_norm < max_norm
        return tree_map(lambda t: torch.where(keep, t, (t / g_norm.to(t.dtype)) * max_norm),
                        updates), state
    return GradientTransformation(lambda params: (), update)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> GradientTransformation:
    def init(params):
        return AdamState(_count(params), tree_map(torch.zeros_like, params),
                         tree_map(torch.zeros_like, params))

    def update(updates, state, params=None):
        mu = tree_map(lambda g, t: (1 - b1) * g + b1 * t, updates, state.mu)
        nu = tree_map(lambda g, t: (1 - b2) * (g * g) + b2 * t, updates, state.nu)
        count = state.count + 1
        c1 = 1 - torch.pow(torch.tensor(b1, device=count.device), count.float())
        c2 = 1 - torch.pow(torch.tensor(b2, device=count.device), count.float())
        out = tree_map(lambda m, v: (m / c1) / (torch.sqrt(v / c2) + eps), mu, nu)
        return out, AdamState(count, mu, nu)
    return GradientTransformation(init, update)


def add_decayed_weights(weight_decay: float) -> GradientTransformation:
    def update(updates, state, params=None):
        return tree_map(lambda g, p: g + weight_decay * p, updates, params), state
    return GradientTransformation(lambda params: (), update)


def scale_by_learning_rate(learning_rate: Union[float, Schedule]) -> GradientTransformation:
    """Multiply by -lr; a schedule is read at the count before this update
    increments it (a warmup from 0 makes the first update zero)."""
    if not callable(learning_rate):
        return GradientTransformation(
            lambda params: (), lambda u, s, params=None: (tree_map(
                lambda g: -learning_rate * g, u), s))

    def init(params):
        return ScheduleState(_count(params))

    def update(updates, state, params=None):
        step = -learning_rate(state.count)
        return tree_map(lambda g: step.to(g.dtype) * g, updates), ScheduleState(state.count + 1)
    return GradientTransformation(init, update)


def adam(learning_rate, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> GradientTransformation:
    return chain(scale_by_adam(b1, b2, eps), scale_by_learning_rate(learning_rate))


def adamw(learning_rate, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4) -> GradientTransformation:
    """Adam with decoupled weight decay on every leaf (no mask)."""
    return chain(scale_by_adam(b1, b2, eps), add_decayed_weights(weight_decay),
                 scale_by_learning_rate(learning_rate))


def sgd(learning_rate) -> GradientTransformation:
    return scale_by_learning_rate(learning_rate)


def multi_steps(tx: GradientTransformation, every_k: int) -> GradientTransformation:
    """optax's ``MultiSteps`` with a constant k: the gradients' running mean
    over k calls, zero updates (parameters frozen) on the first k-1, the
    inner transformation's update of the mean on the k-th. The inner update
    runs on every call and is kept only on the k-th, as optax selects it,
    so that no call reads the step count back to the host."""
    def init(params):
        return MultiStepsState(_count(params), _count(params), tx.init(params),
                               tree_map(torch.zeros_like, params))

    def update(updates, state, params=None):
        acc = tree_map(lambda g, a: a + (g - a) / (state.mini_step + 1).to(a.dtype),
                       updates, state.acc_grads)
        final, inner = tx.update(acc, state.inner_opt_state, params)
        emit = state.mini_step == every_k - 1
        e = emit.to(torch.int32)
        new_state = MultiStepsState(
            (state.mini_step + 1) % every_k,
            e * (state.gradient_step + 1) + (1 - e) * state.gradient_step,
            tree_map(lambda old, new: torch.where(emit, new, old), state.inner_opt_state, inner),
            tree_map(lambda a: (1 - e).to(a.dtype) * a, acc))
        return tree_map(lambda u: e.to(u.dtype) * u, final), new_state
    return GradientTransformation(init, update)
