"""Classifier heads over the feature matrix.

Two head families per BASELINE.json config 2:

* :class:`LogisticHead` — a device-resident multinomial logistic regression
  trained with optax under one jitted ``lax.fori_loop``. Fully on device:
  its scoring path composes with vmap/pjit, which is what makes the batched
  permutation-importance sweep a single device computation
  (``importance/permutation.py``) instead of the reference's joblib process
  pool (ipynb:495-496).
* :class:`RandomForestHead` — an adapter over sklearn's
  ``RandomForestClassifier`` (the reference's head, ipynb:404, but seeded).
  Tree *building* stays on the host (SURVEY.md §7 "hard parts"); inference
  can still run on device via ``models.forest_device``.

``fit_head`` is the public entry point, mirroring notebook cells 19-20
(scale -> fit).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import optax

from tpumcia.config import HeadConfig
from tpumcia.models.scaler import MinMaxScaler


# ---------------------------------------------------------------------------
# Logistic head (device-resident)
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("num_steps", "lr", "l2"))
def _fit_logistic(X, y_onehot, w0, b0, *, num_steps: int, lr: float, l2: float):
    opt = optax.adam(lr)

    def loss_fn(params):
        # DEFAULT matmul precision (TF32 on a GPU): the fit is iterative and
        # approximate anyway; chip_smoke.py checks the rankings it yields
        # against a HIGHEST-precision run
        logits = X @ params["w"] + params["b"]
        ce = optax.softmax_cross_entropy(logits, y_onehot).mean()
        reg = l2 * jnp.sum(params["w"] ** 2)
        return ce + reg

    params = {"w": w0, "b": b0}
    state = opt.init(params)

    def step(_, carry):
        params, state = carry
        grads = jax.grad(loss_fn)(params)
        updates, state = opt.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    params, _ = jax.lax.fori_loop(0, num_steps, step, (params, state))
    return params


def logistic_predict_logits(params, X):
    """Pure scoring function — composes with jit/vmap/pjit. DEFAULT matmul
    precision (TF32 on a GPU), like the fit: only the argmax is used."""
    return jnp.asarray(X) @ params["w"] + params["b"]


def _config_to_npz(cfg: HeadConfig) -> np.ndarray:
    """HeadConfig as a JSON scalar for npz checkpoints (allow_pickle=False
    safe) — without it, load() silently substituted default hyperparameters
    while the forest head's joblib checkpoint kept its config."""
    import dataclasses
    import json

    return np.asarray(json.dumps(dataclasses.asdict(cfg)))


def _config_from_npz(z) -> HeadConfig:
    import json

    if "config_json" not in z:
        return HeadConfig()  # pre-r4 checkpoint
    d = json.loads(str(z["config_json"]))
    if "hidden" in d and isinstance(d["hidden"], list):
        d["hidden"] = tuple(d["hidden"])
    return HeadConfig(**d)


@dataclass
class LogisticHead:
    params: dict[str, jax.Array]
    classes: np.ndarray
    scaler: MinMaxScaler | None = None
    config: HeadConfig = field(default_factory=HeadConfig)

    is_device: bool = True

    def _prep(self, X):
        X = jnp.asarray(X)
        return self.scaler.transform(X) if self.scaler is not None else X

    def predict_logits(self, X) -> jax.Array:
        return logistic_predict_logits(self.params, self._prep(X))

    def predict_proba(self, X) -> jax.Array:
        return jax.nn.softmax(self.predict_logits(X), axis=-1)

    def predict(self, X) -> np.ndarray:
        idx = np.asarray(jnp.argmax(self.predict_logits(X), axis=-1))
        return self.classes[idx]

    def score(self, X, y) -> float:
        """Mean accuracy (sklearn's classifier ``score`` contract)."""
        return float(np.mean(self.predict(X) == np.asarray(y)))

    def save(self, path) -> None:
        """npz checkpoint (params + classes + scaler) — SURVEY.md §5 plan."""
        payload = {
            "w": np.asarray(self.params["w"]),
            "b": np.asarray(self.params["b"]),
            "classes": np.asarray(self.classes),
        }
        payload["config_json"] = _config_to_npz(self.config)
        if self.scaler is not None:
            payload["scaler_min"] = np.asarray(self.scaler.data_min)
            payload["scaler_max"] = np.asarray(self.scaler.data_max)
        np.savez(path, **payload)

    @classmethod
    def load(cls, path) -> "LogisticHead":
        with np.load(path, allow_pickle=False) as z:
            scaler = None
            if "scaler_min" in z:
                scaler = MinMaxScaler.from_stats(z["scaler_min"], z["scaler_max"])
            return cls(
                params={"w": jnp.asarray(z["w"]), "b": jnp.asarray(z["b"])},
                classes=z["classes"],
                scaler=scaler,
                config=_config_from_npz(z),
            )

    def coefficient_importance(self) -> np.ndarray:
        """Normalised mean |weight| per feature — a linear-model analogue of
        the forest's MDI ranking (documented proxy, not an MDI)."""
        w = np.abs(np.asarray(self.params["w"])).mean(axis=1)
        s = w.sum()
        return w / s if s > 0 else w

    @classmethod
    def fit(
        cls,
        X,
        y,
        *,
        config: HeadConfig | None = None,
        scaler: MinMaxScaler | None = None,
        key: jax.Array | None = None,
    ) -> "LogisticHead":
        cfg = config or HeadConfig()
        y = np.asarray(y)
        classes, y_idx = np.unique(y, return_inverse=True)
        X = jnp.asarray(X, jnp.float32)
        if scaler is not None:
            X = scaler.transform(X)
        num_classes = len(classes)
        F = X.shape[1]
        key = key if key is not None else jax.random.key(cfg.seed)
        w0 = jax.random.normal(key, (F, num_classes), jnp.float32) * 0.01
        b0 = jnp.zeros((num_classes,), jnp.float32)
        y_onehot = jax.nn.one_hot(jnp.asarray(y_idx), num_classes)
        params = _fit_logistic(
            X,
            y_onehot,
            w0,
            b0,
            num_steps=cfg.num_steps,
            lr=cfg.learning_rate,
            l2=cfg.l2,
        )
        return cls(params=params, classes=classes, scaler=scaler, config=cfg)


# ---------------------------------------------------------------------------
# MLP head (device-resident)
# ---------------------------------------------------------------------------


def mlp_predict_logits(params, X):
    """Pure scoring for the MLP head: dense->relu stack + linear readout, at
    DEFAULT matmul precision (TF32 on a GPU) like the logistic head."""
    h = jnp.asarray(X)
    for layer in params["hidden"]:
        h = jax.nn.relu(h @ layer["w"] + layer["b"])
    return h @ params["out"]["w"] + params["out"]["b"]


@functools.partial(jax.jit, static_argnames=("num_steps", "lr", "l2"))
def _fit_mlp(X, y_onehot, params0, *, num_steps: int, lr: float, l2: float):
    opt = optax.adam(lr)

    def loss_fn(params):
        logits = mlp_predict_logits(params, X)
        ce = optax.softmax_cross_entropy(logits, y_onehot).mean()
        reg = l2 * sum(
            jnp.sum(layer["w"] ** 2)
            for layer in (*params["hidden"], params["out"])
        )
        return ce + reg

    state = opt.init(params0)

    def step(_, carry):
        params, state = carry
        grads = jax.grad(loss_fn)(params)
        updates, state = opt.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    params, _ = jax.lax.fori_loop(0, num_steps, step, (params0, state))
    return params


@dataclass
class MLPHead:
    """Small fully-connected classifier over the feature matrix — a
    device-resident nonlinear alternative to the forest (same one-jit
    training shape as :class:`LogisticHead`)."""

    params: dict
    classes: np.ndarray
    scaler: MinMaxScaler | None = None
    config: HeadConfig = field(default_factory=HeadConfig)

    is_device: bool = True

    def _prep(self, X):
        X = jnp.asarray(X, jnp.float32)
        return self.scaler.transform(X) if self.scaler is not None else X

    def predict_logits(self, X) -> jax.Array:
        return mlp_predict_logits(self.params, self._prep(X))

    def predict_proba(self, X) -> jax.Array:
        return jax.nn.softmax(self.predict_logits(X), axis=-1)

    def predict(self, X) -> np.ndarray:
        idx = np.asarray(jnp.argmax(self.predict_logits(X), axis=-1))
        return self.classes[idx]

    def score(self, X, y) -> float:
        return float(np.mean(self.predict(X) == np.asarray(y)))

    def save(self, path) -> None:
        """npz checkpoint (layer params + classes + scaler), mirroring
        ``LogisticHead.save`` — SURVEY.md §5 checkpoint plan."""
        payload = {
            "num_hidden": np.int64(len(self.params["hidden"])),
            "out_w": np.asarray(self.params["out"]["w"]),
            "out_b": np.asarray(self.params["out"]["b"]),
            "classes": np.asarray(self.classes),
        }
        for i, layer in enumerate(self.params["hidden"]):
            payload[f"hidden{i}_w"] = np.asarray(layer["w"])
            payload[f"hidden{i}_b"] = np.asarray(layer["b"])
        payload["config_json"] = _config_to_npz(self.config)
        if self.scaler is not None:
            payload["scaler_min"] = np.asarray(self.scaler.data_min)
            payload["scaler_max"] = np.asarray(self.scaler.data_max)
        np.savez(path, **payload)

    @classmethod
    def load(cls, path) -> "MLPHead":
        with np.load(path, allow_pickle=False) as z:
            scaler = None
            if "scaler_min" in z:
                scaler = MinMaxScaler.from_stats(z["scaler_min"], z["scaler_max"])
            hidden = tuple(
                {
                    "w": jnp.asarray(z[f"hidden{i}_w"]),
                    "b": jnp.asarray(z[f"hidden{i}_b"]),
                }
                for i in range(int(z["num_hidden"]))
            )
            return cls(
                params={
                    "hidden": hidden,
                    "out": {
                        "w": jnp.asarray(z["out_w"]),
                        "b": jnp.asarray(z["out_b"]),
                    },
                },
                classes=z["classes"],
                scaler=scaler,
                config=_config_from_npz(z),
            )

    @classmethod
    def fit(
        cls,
        X,
        y,
        *,
        config: HeadConfig | None = None,
        scaler: MinMaxScaler | None = None,
        key: jax.Array | None = None,
    ) -> "MLPHead":
        cfg = config or HeadConfig(kind="mlp")
        y = np.asarray(y)
        classes, y_idx = np.unique(y, return_inverse=True)
        X = jnp.asarray(X, jnp.float32)
        if scaler is not None:
            X = scaler.transform(X)
        key = key if key is not None else jax.random.key(cfg.seed)
        dims = [X.shape[1], *cfg.hidden, len(classes)]
        keys = jax.random.split(key, len(dims) - 1)
        layers = [
            {
                "w": jax.random.normal(k, (d_in, d_out), jnp.float32)
                * jnp.sqrt(2.0 / d_in),
                "b": jnp.zeros((d_out,), jnp.float32),
            }
            for k, d_in, d_out in zip(keys, dims[:-1], dims[1:])
        ]
        params0 = {"hidden": tuple(layers[:-1]), "out": layers[-1]}
        y_onehot = jax.nn.one_hot(jnp.asarray(y_idx), len(classes))
        params = _fit_mlp(
            X, y_onehot, params0,
            num_steps=cfg.num_steps, lr=cfg.learning_rate, l2=cfg.l2,
        )
        return cls(params=params, classes=classes, scaler=scaler, config=cfg)


# ---------------------------------------------------------------------------
# Random forest head (sklearn adapter)
# ---------------------------------------------------------------------------


@dataclass
class RandomForestHead:
    model: Any
    classes: np.ndarray
    scaler: MinMaxScaler | None = None
    config: HeadConfig = field(default_factory=HeadConfig)

    is_device: bool = False

    def _prep(self, X) -> np.ndarray:
        X = np.asarray(X)
        if self.scaler is not None:
            X = np.asarray(self.scaler.transform(X))
        return X

    def predict(self, X) -> np.ndarray:
        return self.model.predict(self._prep(X))

    def predict_proba(self, X) -> np.ndarray:
        return self.model.predict_proba(self._prep(X))

    def score(self, X, y) -> float:
        return float(np.mean(self.predict(X) == np.asarray(y)))

    def mdi_importance(self) -> np.ndarray:
        """Mean-decrease-in-impurity importances (the reference's
        ``model.feature_importances_``, ipynb:434)."""
        return np.asarray(self.model.feature_importances_)

    def save(self, path) -> None:
        """joblib checkpoint of the sklearn forest + scaler (SURVEY.md §5)."""
        import joblib

        joblib.dump(
            {
                "model": self.model,
                "classes": np.asarray(self.classes),
                "scaler": self.scaler.to_numpy() if self.scaler else None,
                "config": self.config,
            },
            path,
        )

    @classmethod
    def load(cls, path) -> "RandomForestHead":
        import joblib

        blob = joblib.load(path)
        scaler = None
        if blob["scaler"] is not None:
            scaler = MinMaxScaler.from_stats(
                blob["scaler"]["data_min"], blob["scaler"]["data_max"]
            )
        return cls(
            model=blob["model"],
            classes=blob["classes"],
            scaler=scaler,
            config=blob["config"],
        )

    def to_device(self):
        """Compile the fitted forest into device arrays for device inference."""
        from tpumcia.models.forest_device import DeviceForest

        return DeviceForest.from_sklearn(self.model, self.classes, self.scaler)

    @classmethod
    def fit(
        cls,
        X,
        y,
        *,
        config: HeadConfig | None = None,
        scaler: MinMaxScaler | None = None,
    ) -> "RandomForestHead":
        from sklearn.ensemble import RandomForestClassifier

        cfg = config or HeadConfig(kind="random_forest")
        X = np.asarray(X)
        if scaler is not None:
            X = np.asarray(scaler.transform(X))
        model = RandomForestClassifier(
            n_estimators=cfg.n_estimators,
            max_depth=cfg.max_depth,
            random_state=cfg.seed,
            n_jobs=-1,
        )
        model.fit(X, np.asarray(y))
        return cls(model=model, classes=model.classes_, scaler=scaler, config=cfg)


# ---------------------------------------------------------------------------
# Public entry point
# ---------------------------------------------------------------------------


def fit_head(
    features,
    labels,
    *,
    config: HeadConfig | None = None,
    scale: bool = True,
    key: jax.Array | None = None,
    scaler: MinMaxScaler | None = None,
):
    """Scale (MinMax, fit on the given data) and fit the configured head.

    ``features`` may be a FeatureMatrix or a raw (N, F) array. Mirrors the
    notebook's scale->fit flow (ipynb:389-406); splitting is the caller's
    concern (see ``utils.split``). A prefit ``scaler`` (e.g. from
    ``parallel.sharding.fit_scaler_sharded``) overrides the internal fit.
    """
    cfg = config or HeadConfig()
    X = getattr(features, "values", features)
    X = np.asarray(X, dtype=np.float32)
    labels_arr = np.asarray(labels)
    if len(labels_arr) != len(X):
        raise ValueError(
            f"fit_head: {len(X)} feature rows but {len(labels_arr)} labels"
        )
    if len(np.unique(labels_arr)) < 2:
        raise ValueError(
            "fit_head needs >= 2 distinct classes; got "
            f"{np.unique(labels_arr)!r} (a grouped/stratified split that "
            "left one class empty?)"
        )
    if scaler is None and scale:
        scaler = MinMaxScaler.fit(X)
    if cfg.kind == "logistic":
        return LogisticHead.fit(X, labels, config=cfg, scaler=scaler, key=key)
    if cfg.kind == "mlp":
        return MLPHead.fit(X, labels, config=cfg, scaler=scaler, key=key)
    if cfg.kind == "random_forest":
        return RandomForestHead.fit(X, labels, config=cfg, scaler=scaler)
    raise ValueError(f"unknown head kind {cfg.kind!r}")
