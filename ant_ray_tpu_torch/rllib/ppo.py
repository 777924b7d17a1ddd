"""PPO core: policy/value nets, GAE, clipped-surrogate update, in
PyTorch on the card (ref: rllib/algorithms/ppo/; the JAX package's
``rllib/ppo.py``, whose jitted step becomes an autograd step here).

Parameters keep the JAX package's trees with the same leaf names and
layouts, as tensors: ``{"pi": [{"w": (fan_in, fan_out), "b": ...}, ...],
"vf": [...]}``.  The products are plain ``torch.matmul``: the JAX package
computes them outside any Pallas kernel, so no flash kernel is on this
path.  Random streams are explicit ``torch.Generator``s.

Besides the PPO pieces, the module holds what every algorithm of the
port shares: the tree helpers, ``value_and_grad`` and :class:`Adam`,
the counterpart of ``optax.adam``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ant_ray_tpu_torch._device import resolve_device

# ------------------------------------------------------------------ trees


def tree_leaves(tree) -> list:
    """Leaves in ``jax.tree.leaves`` order: dict keys sorted, lists in
    order."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for node in tree for leaf in tree_leaves(node)]
    return [tree]


def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` whose leaves are ``leaves``, taken in
    :func:`tree_leaves` order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {key: build(node[key]) for key in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(child) for child in node)
        return next(it)

    return build(like)


def tree_map(fn, tree, *rest):
    """``fn`` of the leaves of ``tree`` (and of the trees shaped like it
    in ``rest``), in a tree of the same shape."""
    columns = [tree_leaves(t) for t in (tree, *rest)]
    return tree_unflatten(tree, [fn(*leaf) for leaf in zip(*columns)])


def to_device(tree, device):
    """Numpy arrays or tensors to tensors of the same dtypes on
    ``device`` (no copy where a leaf is there already)."""
    def tensor(x):
        if isinstance(x, np.ndarray) and not x.flags.writeable:
            x = x.copy()     # torch takes no read-only numpy memory
        return torch.as_tensor(x, device=device)

    return tree_map(tensor, tree)


def copy_to_device(tree, device):
    """Like :func:`to_device`, but every leaf is a copy of its own: the
    trees that Adam updates in place."""
    def copy(x):
        if isinstance(x, torch.Tensor):
            return x.detach().to(device, copy=True)
        return torch.tensor(np.asarray(x), device=device)

    return tree_map(copy, tree)


def to_numpy(tree):
    """A host copy of a tree of tensors."""
    return tree_map(lambda t: t.detach().cpu().numpy().copy(), tree)


def generator(key, device) -> torch.Generator:
    """``key`` itself where it is a ``torch.Generator``, else a generator
    on ``device`` seeded with the integer ``key``."""
    if isinstance(key, torch.Generator):
        return key
    return torch.Generator(device=device).manual_seed(int(key))


def value_and_grad(loss_fn, params, *args, **kwargs):
    """``jax.value_and_grad(loss_fn, has_aux=True)(params, ...)``:
    (loss, metrics, grads), the grads a tree shaped like ``params``.  A
    leaf the loss does not reach gets a zero gradient, as in JAX."""
    leaves = [leaf.detach().requires_grad_(True)
              for leaf in tree_leaves(params)]
    loss, metrics = loss_fn(tree_unflatten(params, leaves), *args, **kwargs)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(leaf) if g is None else g
             for leaf, g in zip(leaves, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_unflatten(params, grads))


class Adam:
    """``optax.adam(lr)`` over a tree of tensors: b1 0.9, b2 0.999, eps
    1e-8 added after the square root, bias-corrected moments, every leaf
    updated on every step (a zero gradient included).  The update is in
    place, on the leaves of ``params`` and of the state, the way the JAX
    package's jitted steps donate theirs."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps

    def init(self, params) -> dict:
        return {"count": 0,
                "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    @torch.no_grad()
    def update(self, grads, state: dict, params):
        """Apply one step; returns ``(params, state)``, the same trees."""
        p, g = tree_leaves(params), tree_leaves(grads)
        mu, nu = tree_leaves(state["mu"]), tree_leaves(state["nu"])
        state["count"] += 1
        count = state["count"]
        # optax's update_moment: (1 - b) * g + b * m, g squared for nu.
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1.0 - self.b1))
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, torch._foreach_mul(
            torch._foreach_mul(g, g), 1.0 - self.b2))
        mu_hat = torch._foreach_div(mu, 1.0 - self.b1 ** count)
        denom = torch._foreach_sqrt(
            torch._foreach_div(nu, 1.0 - self.b2 ** count))
        torch._foreach_add_(denom, self.eps)
        step = torch._foreach_div(mu_hat, denom)
        torch._foreach_add_(p, torch._foreach_mul(step, -self.lr))
        return params, state


def opt_state_to_numpy(state: dict) -> dict:
    return {"count": state["count"], "mu": to_numpy(state["mu"]),
            "nu": to_numpy(state["nu"])}


def opt_state_to_device(state: dict, device) -> dict:
    return {"count": int(state["count"]),
            "mu": copy_to_device(state["mu"], device),
            "nu": copy_to_device(state["nu"], device)}


# --------------------------------------------------------------- networks


def dense_init(key, fan_in: int, fan_out: int, device=None):
    """He-initialized dense layer params (shared by every MLP in the
    catalog: ppo towers and rl_module modules alike).  ``key`` is a
    ``torch.Generator`` on ``device`` or an integer seed."""
    device = resolve_device(device)
    gen = generator(key, device)
    w = torch.randn(fan_in, fan_out, generator=gen, device=device)
    return {"w": w * np.sqrt(2.0 / fan_in),
            "b": torch.zeros(fan_out, device=device)}


def mlp_forward(layers, x):
    """tanh-MLP forward over a layer list (RLlib's default fcnet)."""
    for layer in layers[:-1]:
        x = torch.tanh(x @ layer["w"] + layer["b"])
    last = layers[-1]
    return x @ last["w"] + last["b"]


def init_policy(key, obs_dim: int, n_actions: int, hidden: int = 64,
                device=None):
    """Separate policy/value MLP towers (RLlib's default fcnet), drawn
    one layer after another from one generator."""
    device = resolve_device(device)
    gen = generator(key, device)
    return {
        "pi": [dense_init(gen, obs_dim, hidden, device),
               dense_init(gen, hidden, hidden, device),
               dense_init(gen, hidden, n_actions, device)],
        "vf": [dense_init(gen, obs_dim, hidden, device),
               dense_init(gen, hidden, hidden, device),
               dense_init(gen, hidden, 1, device)],
    }


def policy_logits(params, obs):
    return mlp_forward(params["pi"], obs)


def value(params, obs):
    return mlp_forward(params["vf"], obs)[..., 0]


def categorical(gen: torch.Generator, logits):
    """``jax.random.categorical``: the Gumbel-max draw, one per row, from
    ``gen``'s stream."""
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    u = u.clamp_(min=torch.finfo(u.dtype).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


@torch.no_grad()
def act(params, obs, gen: torch.Generator):
    """Sample actions + logp + value for a batch of observations."""
    logits = policy_logits(params, obs)
    actions = categorical(gen, logits)
    logp = F.log_softmax(logits, dim=-1).gather(
        -1, actions[:, None])[:, 0]
    return actions, logp, value(params, obs)


def compute_gae(rewards, values, dones, last_values, *, gamma: float,
                lam: float):
    """Generalized advantage estimation over a (T, N) rollout (numpy:
    rollouts live on the host), the JAX package's function as it is."""
    T, N = rewards.shape
    adv = np.zeros((T, N), np.float32)
    last_gae = np.zeros(N, np.float32)
    next_value = last_values
    for t in range(T - 1, -1, -1):
        nonterminal = 1.0 - dones[t]
        delta = rewards[t] + gamma * next_value * nonterminal - values[t]
        last_gae = delta + gamma * lam * nonterminal * last_gae
        adv[t] = last_gae
        next_value = values[t]
    returns = adv + values
    return adv, returns


def entropy_of(logp_all):
    return -torch.mean(torch.sum(torch.exp(logp_all) * logp_all, dim=-1))


def normalize(adv):
    """``(adv - mean) / (std + 1e-8)`` with ``jnp.std``'s divisor N."""
    return (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)


def ppo_loss(params, batch, *, clip: float, vf_coeff: float,
             ent_coeff: float):
    logits = policy_logits(params, batch["obs"])
    logp_all = F.log_softmax(logits, dim=-1)
    logp = logp_all.gather(-1, batch["actions"][:, None])[:, 0]
    ratio = torch.exp(logp - batch["logp_old"])
    adv = normalize(batch["advantages"])
    surrogate = torch.minimum(
        ratio * adv, torch.clamp(ratio, 1 - clip, 1 + clip) * adv)
    pi_loss = -surrogate.mean()
    vf_loss = torch.mean((value(params, batch["obs"])
                          - batch["returns"]) ** 2)
    entropy = entropy_of(logp_all)
    total = pi_loss + vf_coeff * vf_loss - ent_coeff * entropy
    return total, {"pi_loss": pi_loss, "vf_loss": vf_loss,
                   "entropy": entropy}


def make_update_step(optimizer: Adam, *, clip: float, vf_coeff: float,
                     ent_coeff: float):
    """One minibatch SGD step: ``step(params, opt_state, batch) ->
    (params, opt_state, metrics)``, updating in place."""

    def step(params, opt_state, batch):
        loss, metrics, grads = value_and_grad(
            ppo_loss, params, batch, clip=clip, vf_coeff=vf_coeff,
            ent_coeff=ent_coeff)
        params, opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, dict(metrics, total_loss=loss)

    return step
