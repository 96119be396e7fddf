import numpy as np

from biograph_jax.classifier.model import (
    Classifier,
    train_classifier,
)


def _fake_features(rng, n, true_frac=0.5):
    is_true = rng.random(n) < true_frac
    alt = np.where(is_true, rng.poisson(25, n), rng.poisson(3, n))
    ref = np.where(is_true, rng.poisson(3, n), rng.poisson(25, n))
    feats = {
        "alt_depth": alt,
        "ref_depth": ref,
        "alt_frac": alt / np.maximum(alt + ref, 1),
        "var_len": rng.integers(-5, 5, n),
        "is_snp": rng.integers(0, 2, n),
        "gq": np.where(is_true, rng.poisson(60, n), rng.poisson(10, n)),
        "qual": rng.poisson(100, n).astype(float),
    }
    return feats, is_true


def test_train_and_separate(rng):
    feats, labels = _fake_features(rng, 2000)
    clf = train_classifier(feats, labels, steps=600)
    prob = clf.predict_proba(feats)
    acc = ((prob > 0.5) == labels).mean()
    assert acc > 0.95, acc


def test_save_load(rng, tmp_path):
    feats, labels = _fake_features(rng, 500)
    clf = train_classifier(feats, labels, steps=200)
    p = str(tmp_path / "clf.npz")
    clf.save(p)
    clf2 = Classifier.load(p)
    a = clf.predict_proba(feats)
    b = clf2.predict_proba(feats)
    assert np.allclose(a, b, atol=1e-5)
