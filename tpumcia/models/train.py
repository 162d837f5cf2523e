"""CNN training: sharded train step over a (data, model) mesh.

One jitted train step; the batch is sharded over ``data``, parameters are
replicated except the classifier Dense kernel, which is sharded over the
``model`` axis (tensor parallelism on the head — the one layer whose width
scales with channel/class count). XLA inserts the gradient psum over ICI
(SURVEY.md §2.4 plan).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpumcia.models.cnn import ResNet, make_resnet


@dataclass
class CNNConfig:
    num_classes: int
    width: int = 64
    depth: str = "18"
    learning_rate: float = 1e-3
    weight_decay: float = 1e-4
    batch_size: int = 64
    epochs: int = 5
    seed: int = 0


def _param_sharding(params, mesh: Mesh):
    """Classifier kernel sharded over 'model'; everything else replicated."""

    n_model = mesh.shape["model"]

    def assign(path, leaf):
        keys = [getattr(p, "key", getattr(p, "name", "")) for p in path]
        if (
            "classifier" in keys
            and leaf.ndim == 2
            and leaf.shape[1] % n_model == 0
        ):
            return NamedSharding(mesh, P(None, "model"))
        return NamedSharding(mesh, P())

    return jax.tree_util.tree_map_with_path(assign, params)


@functools.lru_cache(maxsize=16)
def _model_apply_for(model: ResNet):
    """Stable-identity apply closure per model config (ResNet is a frozen
    dataclass, so identical configs hit the cache). jits keyed on a
    ``Partial`` over this closure cache across CNNHead instances — a fresh
    closure per call would retrace every sweep."""

    def f(params, x):
        return model.apply({"params": params}, x)

    return f


@jax.jit
def _apply_logits(apply_fn, x):
    return apply_fn(x)


@dataclass
class CNNHead:
    model: ResNet
    params: Any
    classes: np.ndarray
    mesh: Mesh | None = None
    config: CNNConfig | None = None
    history: list = field(default_factory=list)

    is_device: bool = True

    def apply_fn(self):
        from jax.tree_util import Partial

        return Partial(_model_apply_for(self.model), self.params)

    def predict_logits(self, images) -> jax.Array:
        x = jnp.asarray(images, jnp.float32)
        if self.mesh is not None and jax.process_count() > 1:
            # params live on a cross-process mesh: a locally-committed x
            # would be rejected by the jit — replicate it over the mesh
            # device-to-device (inference inputs are identical on every
            # process; no host round trip)
            from tpumcia.parallel.sharding import _replicate_over_mesh

            x = _replicate_over_mesh(x, self.mesh)
        return _apply_logits(self.apply_fn(), x)

    def predict_proba(self, images) -> jax.Array:
        return jax.nn.softmax(self.predict_logits(images), axis=-1)

    def predict(self, images) -> np.ndarray:
        idx = np.asarray(jnp.argmax(self.predict_logits(images), axis=-1))
        return self.classes[idx]

    def score(self, images, y) -> float:
        return float(np.mean(self.predict(images) == np.asarray(y)))

    def save(self, path: str) -> None:
        """Orbax checkpoint of params + classes."""
        import orbax.checkpoint as ocp

        ckpt = ocp.StandardCheckpointer()
        ckpt.save(
            path,
            {"params": jax.tree.map(np.asarray, self.params),
             "classes": np.asarray(self.classes)},
            force=True,
        )
        ckpt.wait_until_finished()

    @classmethod
    def load(cls, path: str, *, config: CNNConfig) -> "CNNHead":
        import orbax.checkpoint as ocp

        ckpt = ocp.StandardCheckpointer()
        restored = ckpt.restore(path)
        model = make_resnet(
            config.num_classes, width=config.width, depth=config.depth
        )
        return cls(
            model=model,
            params=restored["params"],
            classes=np.asarray(restored["classes"]),
            config=config,
        )


def make_train_step(model: ResNet, tx):
    """(params, opt_state, images, labels_onehot) -> (params, opt_state, loss).
    Pure; jit/pjit-able with any shardings."""

    def loss_fn(params, images, y_onehot):
        logits = model.apply({"params": params}, images)
        return optax.softmax_cross_entropy(logits, y_onehot).mean()

    def step(params, opt_state, images, y_onehot):
        loss, grads = jax.value_and_grad(loss_fn)(params, images, y_onehot)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return step


@functools.lru_cache(maxsize=16)
def _build_train(model: ResNet, learning_rate: float, weight_decay: float):
    """(tx, step) with stable identity per (model config, optimizer config) —
    the jit on :func:`_epoch_fn` keys on ``step``, so repeated ``fit_cnn``
    calls (and the warm-up/timed split in benchmarks) reuse one trace.
    Tracing the ResNet backward scan costs tens of seconds on a slow host."""
    tx = optax.adamw(learning_rate, weight_decay=weight_decay)
    return tx, make_train_step(model, tx)


@functools.lru_cache(maxsize=16)
def _init_jit(model: ResNet, learning_rate: float, weight_decay: float):
    """Jitted (rng, x0) -> (params, opt_state), cached per config.

    Un-jitted ``model.init`` + ``tx.init`` run EAGERLY — 100+ tiny device
    dispatches (one per layer init / zeros_like leaf). One fused dispatch
    replaces that queue."""
    tx, _ = _build_train(model, learning_rate, weight_decay)

    def f(rng, x0):
        params = model.init(rng, x0)["params"]
        return params, tx.init(params)

    return jax.jit(f)


@functools.partial(jax.jit, static_argnames=("step", "data_shard"))
def _epoch_fn(params, opt_state, images_all, y_all, idx_all, *, step,
              data_shard):
    """One epoch = ONE dispatch: a lax.scan over the (steps, batch) gather
    indices. Per-step Python dispatch + a blocking loss fetch would
    serialize host and device every step; here the whole epoch runs
    device-side with one small losses fetch."""

    def body(carry, idx):
        params, opt_state = carry
        xb = jnp.take(images_all, idx, axis=0)
        yb = jnp.take(y_all, idx, axis=0)
        if data_shard is not None:
            xb = jax.lax.with_sharding_constraint(xb, data_shard)
            yb = jax.lax.with_sharding_constraint(yb, data_shard)
        params, opt_state, loss = step(params, opt_state, xb, yb)
        return (params, opt_state), loss

    (params, opt_state), losses = jax.lax.scan(
        body, (params, opt_state), idx_all
    )
    return params, opt_state, losses


def fit_cnn(
    images,
    labels,
    *,
    config: CNNConfig | None = None,
    mesh: Mesh | None = None,
    images_eval=None,
    labels_eval=None,
    verbose: bool = False,
) -> CNNHead:
    """Train the ResNet on (B, H, W, C) images in [0, 1] (float) or [0, 255]
    (integer, normalised internally)."""
    if getattr(images, "ndim", np.ndim(images)) != 4:
        raise ValueError(
            f"fit_cnn expects (B, H, W, C) images; got shape "
            f"{tuple(np.shape(images))}"
        )
    labels = np.asarray(labels)
    if labels.shape != (images.shape[0],):
        raise ValueError(
            f"labels shape {labels.shape} does not match the "
            f"{images.shape[0]} images"
        )
    classes, y_idx = np.unique(labels, return_inverse=True)
    cfg = config or CNNConfig(num_classes=len(classes))
    # keep device arrays resident (np.asarray on a device array would copy
    # 100s of MB to the host); normalise integer inputs on device
    images_all = jnp.asarray(images)
    if jnp.issubdtype(images_all.dtype, jnp.integer):
        images_all = images_all.astype(jnp.float32) / 255.0
    else:
        images_all = images_all.astype(jnp.float32)

    model = make_resnet(cfg.num_classes, width=cfg.width, depth=cfg.depth)
    rng = jax.random.key(cfg.seed)
    tx, step = _build_train(model, cfg.learning_rate, cfg.weight_decay)
    params, opt_state = _init_jit(model, cfg.learning_rate, cfg.weight_decay)(
        rng, jnp.zeros((1,) + images_all.shape[1:], jnp.float32)
    )

    data_shard = NamedSharding(mesh, P("data")) if mesh is not None else None
    multiproc = mesh is not None and jax.process_count() > 1

    if mesh is not None:
        # params/opt-state shardings are seeded by the device_put below and
        # then propagated by jit; epoch data stays replicated, each gathered
        # batch is constrained onto the data axis.
        if multiproc:
            # a cross-process jit rejects locally-committed inputs:
            # redistribute the (identical per process) locally-initialised
            # state over the mesh device-to-device. fit_cnn's multi-process
            # contract is the replicated-dataset one: every process passes
            # the SAME full (images, labels); the per-epoch sampling is
            # seeded so all processes drive identical global steps, with
            # the batch sharded over the mesh's data axis (DCN/ICI
            # gradient psum via jit).
            from tpumcia.parallel.sharding import place_global

            rep = NamedSharding(mesh, P())
            opt_state = jax.tree.map(
                lambda l: place_global(jnp.asarray(l), rep), opt_state
            )
            # bulk data replicates device-to-device — np.asarray would copy
            # the full image set through the host twice
            images_all = place_global(images_all, rep)
            shardings = _param_sharding(params, mesh)
            params = jax.tree.map(
                lambda l, s: place_global(jnp.asarray(l), s),
                params, shardings,
            )
        else:
            params = jax.device_put(params, _param_sharding(params, mesh))

    # The epoch order is padded with wrap-around samples to a multiple of
    # batch_size so every sample trains each epoch at one compiled shape —
    # the tail batch is not dropped.
    n = images_all.shape[0]
    bs = min(cfg.batch_size, n)
    steps_per_epoch = -(-n // bs)
    rng_np = np.random.default_rng(cfg.seed)
    y_all = jax.nn.one_hot(jnp.asarray(y_idx), cfg.num_classes)
    if multiproc:
        from tpumcia.parallel.sharding import place_global

        y_all = place_global(y_all, NamedSharding(mesh, P()))
    history = []
    # When nothing needs the loss mid-training, defer every loss fetch to the
    # end: a blocking float() per epoch is a device-to-host sync that also
    # serializes the epoch dispatches. With deferred fetches all epochs
    # enqueue back-to-back and the sync is paid once.
    eager_history = verbose or images_eval is not None
    epoch_losses: list = []
    for epoch in range(cfg.epochs):
        order = rng_np.permutation(n)
        pad = steps_per_epoch * bs - n
        if pad:
            order = np.concatenate([order, order[:pad]])
        idx_all = order.reshape(steps_per_epoch, bs)
        idx_all = (
            jax.device_put(idx_all, NamedSharding(mesh, P()))
            if multiproc
            else jnp.asarray(idx_all)
        )
        params, opt_state, losses = _epoch_fn(
            params, opt_state, images_all, y_all, idx_all,
            step=step, data_shard=data_shard,
        )
        if eager_history:
            entry = {"epoch": epoch, "loss": float(jnp.mean(losses))}
            if images_eval is not None:
                head = CNNHead(model=model, params=params, classes=classes,
                               mesh=mesh, config=cfg)
                entry["eval_acc"] = head.score(images_eval, labels_eval)
            history.append(entry)
            if verbose:
                print(entry)
        else:
            epoch_losses.append(jnp.mean(losses))
    if not eager_history and epoch_losses:
        means = np.asarray(jnp.stack(epoch_losses))  # one fetch for all epochs
        history = [
            {"epoch": e, "loss": float(m)} for e, m in enumerate(means)
        ]
    return CNNHead(
        model=model, params=params, classes=classes, mesh=mesh, config=cfg,
        history=history,
    )
