"""Variant quality classifier — on-device MLP.

Counterpart of the reference's RandomForest QUAL classifier
(python/biograph/classifier/build_classifier.py:105: 500-tree sklearn RF over
per-variant coverage features; qual_classifier.py:271-302 applies it to set
VCF QUAL and filter).  This build replaces forest inference with a small
jitted MLP trained with Adam — same feature matrix in, same
probability-of-true-variant out; training and inference both run on device
and batch over the whole call set at once.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Dict, List

import numpy as np
import jax
import jax.numpy as jnp
import optax
from jax import lax

FEATURES = [
    "alt_depth", "ref_depth", "alt_frac", "var_len", "is_snp", "gq", "qual",
    "pair_cov",
    # flank + ratio evidence (the reference DataFrame's US/DS coverage and
    # transform_dp alt-ref ratio features, gt_classifier.py:58-90); absent
    # in older feature files -> zeros
    "us_alt", "ds_alt", "us_ref", "ds_ref", "ad_ratio",
    # pcmp parity columns (tools/coverage.py build_table_header):
    # VARTYPE/VARLEN/REFSPAN/ASMLEN, window-shape XC/MC/EC per allele,
    # REFGC/ALTGC sequence context, PL_* genotype likelihoods
    "var_type", "abs_var_len", "refspan", "asmlen",
    "xc_alt", "mc_alt", "ec_alt", "xc_ref", "mc_ref", "ec_ref",
    "gc_alt", "gc_ref", "pl_ref", "pl_het", "pl_hom",
]

_LOG_FEATURES = frozenset(
    (
        "alt_depth", "ref_depth", "gq", "qual", "pair_cov",
        "us_alt", "ds_alt", "us_ref", "ds_ref",
        "abs_var_len", "refspan", "asmlen",
        "xc_alt", "mc_alt", "ec_alt", "xc_ref", "mc_ref", "ec_ref",
        "pl_ref", "pl_het", "pl_hom",
    )
)


def stack_features(feats: Dict[str, np.ndarray]) -> np.ndarray:
    n = len(np.asarray(next(iter(feats.values()))))
    cols = []
    for name in FEATURES:
        if name in feats:
            col = np.asarray(feats[name], np.float32)
        else:
            col = np.zeros(n, np.float32)  # older feature files lack columns
        if name in _LOG_FEATURES:
            col = np.log1p(np.maximum(col, 0))
        if name == "var_len":
            col = np.sign(col) * np.log1p(np.abs(col))
        cols.append(col)
    return np.stack(cols, axis=1)


@dataclass
class Classifier:
    params: dict
    mean: np.ndarray
    std: np.ndarray

    def predict_proba(self, feats: Dict[str, np.ndarray]) -> np.ndarray:
        x = (stack_features(feats) - self.mean) / self.std
        return np.asarray(_forward(self.params, jnp.asarray(x)))

    def save(self, path: str):
        flat = {
            f"w{i}": np.asarray(self.params[f"w{i}"]) for i in range(3)
        } | {f"b{i}": np.asarray(self.params[f"b{i}"]) for i in range(3)}
        np.savez(path, mean=self.mean, std=self.std, **flat)

    @staticmethod
    def load(path: str) -> "Classifier":
        z = np.load(path)
        params = {k: jnp.asarray(z[k]) for k in z.files if k[0] in "wb" and k not in ("mean",)}
        return Classifier(params=params, mean=z["mean"], std=z["std"])


def _init(rng, sizes):
    params = {}
    keys = jax.random.split(rng, len(sizes) - 1)
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        params[f"w{i}"] = jax.random.normal(keys[i], (a, b)) * np.sqrt(2.0 / a)
        params[f"b{i}"] = jnp.zeros((b,))
    return params


def _logits(params, x):
    # HIGHEST: a GPU would otherwise run these float32 products in TF32
    # (~3 decimal digits), which can flip PASS decisions against the CPU
    dot = partial(jnp.matmul, precision=lax.Precision.HIGHEST)
    h = x
    n_layers = len([k for k in params if k.startswith("w")])
    for i in range(n_layers - 1):
        h = jax.nn.relu(dot(h, params[f"w{i}"]) + params[f"b{i}"])
    return dot(h, params[f"w{n_layers-1}"]) + params[f"b{n_layers-1}"]


def _forward(params, x):
    return jax.nn.sigmoid(_logits(params, x)[:, 0])


def train_classifier(
    feats: Dict[str, np.ndarray],
    labels: np.ndarray,
    hidden: int = 32,
    steps: int = 2000,
    lr: float = 1e-2,
    seed: int = 0,
) -> Classifier:
    """Train on (features, bool labels); returns a fitted Classifier."""
    x = stack_features(feats)
    mean = x.mean(axis=0)
    std = x.std(axis=0) + 1e-6
    xn = jnp.asarray((x - mean) / std)
    y = jnp.asarray(np.asarray(labels, np.float32))
    params = _init(jax.random.PRNGKey(seed), [x.shape[1], hidden, hidden, 1])
    opt = optax.adam(lr)
    state = opt.init(params)

    @jax.jit
    def step(params, state):
        def loss_fn(p):
            prob = _forward(p, xn)
            eps = 1e-7
            return -jnp.mean(
                y * jnp.log(prob + eps) + (1 - y) * jnp.log(1 - prob + eps)
            )

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, state2 = opt.update(grads, state)
        return optax.apply_updates(params, updates), state2, loss

    for _ in range(steps):
        params, state, loss = step(params, state)
    return Classifier(params=params, mean=mean, std=std)


GT_CLASSES = ("0/0", "0/1", "1/1")


@dataclass
class GtClassifier:
    """3-class genotype model (REF/HET/HOM) over the coverage features —
    counterpart of the reference's gt_classifier RandomForest
    (python/biograph/classifier/gt_classifier.py:112 run_model)."""

    params: dict
    mean: np.ndarray
    std: np.ndarray

    def predict_proba(self, feats: Dict[str, np.ndarray]) -> np.ndarray:
        x = (stack_features(feats) - self.mean) / self.std
        return np.asarray(jax.nn.softmax(_logits(self.params, jnp.asarray(x)), axis=-1))

    def predict(self, feats: Dict[str, np.ndarray]) -> np.ndarray:
        return self.predict_proba(feats).argmax(axis=1)

    def save(self, path: str):
        flat = {
            k: np.asarray(v) for k, v in self.params.items()
        }
        np.savez(path, mean=self.mean, std=self.std, gt_model=True, **flat)

    @staticmethod
    def load(path: str) -> "GtClassifier":
        z = np.load(path)
        if "gt_model" not in z.files:
            raise ValueError(f"{path}: not a gt_classifier model")
        params = {
            k: jnp.asarray(z[k]) for k in z.files if k[0] in "wb" and k != "mean"
        }
        return GtClassifier(params=params, mean=z["mean"], std=z["std"])


def train_gt_classifier(
    feats: Dict[str, np.ndarray],
    gt_labels: np.ndarray,
    hidden: int = 32,
    steps: int = 2000,
    lr: float = 1e-2,
    seed: int = 0,
) -> GtClassifier:
    """Train the 3-class GT model; gt_labels are ints (0=0/0, 1=0/1, 2=1/1)."""
    x = stack_features(feats)
    mean = x.mean(axis=0)
    std = x.std(axis=0) + 1e-6
    xn = jnp.asarray((x - mean) / std)
    y = jnp.asarray(np.asarray(gt_labels, np.int32))
    params = _init(
        jax.random.PRNGKey(seed), [x.shape[1], hidden, hidden, len(GT_CLASSES)]
    )
    opt = optax.adam(lr)
    state = opt.init(params)

    @jax.jit
    def step(params, state):
        def loss_fn(p):
            lp = jax.nn.log_softmax(_logits(p, xn), axis=-1)
            return -jnp.mean(jnp.take_along_axis(lp, y[:, None], axis=1))

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, state2 = opt.update(grads, state)
        return optax.apply_updates(params, updates), state2, loss

    for _ in range(steps):
        params, state, loss = step(params, state)
    return GtClassifier(params=params, mean=mean, std=std)


def _phred(p: np.ndarray) -> np.ndarray:
    with np.errstate(divide="ignore"):
        r = -10.0 * np.log10(np.maximum(p, 0.0))
    return np.minimum(np.round(np.nan_to_num(r, posinf=99.0)), 99).astype(int)


def gt_apply_to_vcf(
    clf: GtClassifier,
    vcf_in: str,
    vcf_out: str,
    feats: Dict[str, np.ndarray],
    sample: str = "SAMPLE",
):
    """Re-genotype a VCF from the GT model (gt_classifier.py run_model/
    edit_vcf behavior: GT from argmax class, PL = phred per-class
    probabilities capped at 99, GQ = second-best PL minus best)."""
    from biograph_jax.io.vcf import read_vcf, VcfWriter

    records = read_vcf(vcf_in)
    proba = clf.predict_proba(feats)
    assert len(proba) == len(records)
    pl = _phred(proba)
    srt = np.sort(pl, axis=1)
    gq = srt[:, 1] - srt[:, 0]
    cls = proba.argmax(axis=1)
    headers = [
        '##FORMAT=<ID=PL,Number=G,Type=Integer,Description="Phred-scaled genotype likelihoods">',
        '##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="Genotype quality">',
    ]
    with VcfWriter(vcf_out, sample=sample, extra_headers=headers) as w:
        for i, rec in enumerate(records):
            rec.fmt["GT"] = GT_CLASSES[int(cls[i])]
            rec.fmt["GQ"] = int(gq[i])
            rec.fmt["PL"] = ",".join(str(int(v)) for v in pl[i])
            w.write(rec)
    return cls


def apply_to_vcf(
    clf: Classifier,
    vcf_in: str,
    vcf_out: str,
    feats: Dict[str, np.ndarray],
    min_prob: float = 0.5,
    sample: str = "SAMPLE",
):
    """Rewrite QUAL/FILTER from classifier probabilities
    (qual_classifier.py:271-302 behavior: QUAL = phred(prob), PASS/lowq)."""
    from biograph_jax.io.vcf import read_vcf, VcfWriter

    records = read_vcf(vcf_in)
    prob = clf.predict_proba(feats)
    assert len(prob) == len(records)
    with VcfWriter(vcf_out, sample=sample) as w:
        for rec, p in zip(records, prob):
            rec.qual = max(round(float(-10 * np.log10(max(1 - p, 1e-10))), 1), 0.0)
            rec.filter = "PASS" if p >= min_prob else "lowq"
            w.write(rec)
    return prob
