"""Classifier evaluation beyond the 17-record toy gate (VERDICT r3 #8).

Trains the QUAL classifier on the lambda trio parents' pcmp feature frames
(positives) + weak-support synthetics (negatives — the class the QUAL
classifier exists to fail, as in the reference's TP-vs-FP training,
classifier/build_classifier.py), then reports ROC-AUC / accuracy on:

  * lambda proband: records the reference RF passed 17/17, plus junk
    negatives in the proband's coordinate frame;
  * HIV ERR381524: discovery calls on the divergent sample (an entirely
    different genome/coverage regime), validated through the donor-patched
    coverage walk, plus junk negatives — the generalization leg.

Also reports the 3-class GT re-genotyper's accuracy on the proband vs the
pcmp genotyper.  Writes CLASSIFIER_METRICS.json at the repo root; the
matching regression gate is tests/test_classifier_lambda.py.
"""

import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

BENCH = "/root/reference/datasets/lambdaToyData/benchmark"
BASE = "/root/reference/datasets/ml_toydata_lambda"


def roc_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Rank-based AUC (Mann-Whitney U), ties handled by average rank."""
    labels = np.asarray(labels, bool)
    order = np.argsort(scores, kind="stable")
    ranks = np.empty(len(scores), np.float64)
    s = scores[order]
    i = 0
    r = 1.0
    while i < len(s):
        j = i
        while j + 1 < len(s) and s[j + 1] == s[i]:
            j += 1
        ranks[order[i : j + 1]] = (r + (r + (j - i))) / 2
        r += j - i + 1
        i = j + 1
    n_pos = labels.sum()
    n_neg = len(labels) - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    return float((ranks[labels].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def lambda_features(sample):
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
    return records, feature_matrix(records, ann, pc), ann


def hiv_features():
    from biograph_jax.io.bgimport import open_bg_dir
    from biograph_jax.index.reference import Reference
    from biograph_jax.io.vcf import VcfRecord
    from biograph_jax.variants.coverage_tool import (
        annotate_coverage,
        annotate_pair_coverage,
        feature_matrix,
    )
    from biograph_jax.variants.discover import DiscoverOptions, discover_variants

    ss, rm, _ = open_bg_dir("/root/reference/datasets/hiv/biograph/ERR381524.bg")
    ref = Reference.from_fasta(
        "/root/reference/datasets/hiv/ref/hiv-1-NC_001802.1.fa"
    )
    opt = DiscoverOptions(min_alt_support=5, bidir=True)
    recs = [
        r
        for r in discover_variants(ss, ref, opt=opt, readmap=rm)
        if r["support"] >= 5
    ]
    vrecs = [
        VcfRecord(chrom=r["chrom"], pos=r["pos"], ref=r["ref"], alt=r["alt"])
        for r in recs
    ]
    ann = annotate_coverage(rm, ref, vrecs)
    pc = annotate_pair_coverage(rm, ref, vrecs)
    keep = ann.alt_depth >= 3  # independently validated calls only
    feats = feature_matrix(vrecs, ann, pc)
    return {k: np.asarray(v)[keep] for k, v in feats.items()}


def stack(feats_list):
    keys = feats_list[0].keys()
    return {k: np.concatenate([f[k] for f in feats_list]) for k in keys}


def synthetic_negatives(rng, n, like):
    """Weak-support profiles (see tests/test_classifier_lambda.py)."""
    out = {k: np.zeros(n, np.asarray(v).dtype) for k, v in like.items()}
    out["alt_depth"] = rng.integers(0, 3, n).astype(out["alt_depth"].dtype)
    out["ref_depth"] = rng.integers(20, 120, n).astype(out["ref_depth"].dtype)
    out["alt_frac"] = (
        out["alt_depth"] / np.maximum(out["alt_depth"] + out["ref_depth"], 1)
    ).astype(np.float32)
    out["var_len"] = rng.integers(-3, 4, n).astype(out["var_len"].dtype)
    out["is_snp"] = (out["var_len"] == 0).astype(out["is_snp"].dtype)
    out["gq"] = rng.integers(0, 6, n).astype(out["gq"].dtype)
    out["qual"] = rng.uniform(0, 20, n).astype(np.float32)
    if "xc_alt" in out:
        out["xc_alt"] = rng.integers(0, 4, n).astype(out["xc_alt"].dtype)
        out["xc_ref"] = rng.integers(25, 130, n).astype(out["xc_ref"].dtype)
        out["mc_ref"] = out["xc_ref"].astype(np.float32) * 0.8
        out["ec_ref"] = (out["xc_ref"] * 0.7).astype(out["ec_ref"].dtype)
    return out


def compute_metrics(seed=7):
    from biograph_jax.classifier.model import (
        GT_CLASSES,
        train_classifier,
        train_gt_classifier,
    )

    rng = np.random.default_rng(seed)
    recs_f, f_f, _ = lambda_features("father")
    recs_m, f_m, _ = lambda_features("mother")
    recs_p, f_p, _ = lambda_features("proband")
    train_pos = stack([f_f, f_m])
    n_pos = len(train_pos["alt_depth"])
    feats = stack([train_pos, synthetic_negatives(rng, 4 * n_pos, train_pos)])
    labels = np.concatenate([np.ones(n_pos, bool), np.zeros(4 * n_pos, bool)])
    clf = train_classifier(feats, labels, seed=seed)

    out = {"n_features": len(stack_cols())}

    # lambda proband leg
    junk_p = synthetic_negatives(rng, 100, f_p)
    eval_feats = stack([f_p, junk_p])
    eval_labels = np.concatenate([np.ones(len(f_p["alt_depth"]), bool), np.zeros(100, bool)])
    p = clf.predict_proba(eval_feats)
    out["lambda_proband"] = {
        "n_true": int(eval_labels.sum()),
        "n_junk": int((~eval_labels).sum()),
        "roc_auc": round(roc_auc(eval_labels, p), 4),
        "accuracy": round(float(((p >= 0.5) == eval_labels).mean()), 4),
        "true_pass_rate": round(float((p[eval_labels] >= 0.5).mean()), 4),
    }

    # HIV generalization leg (model trained on lambda only)
    f_h = hiv_features()
    junk_h = synthetic_negatives(rng, 100, f_h)
    hf = stack([f_h, junk_h])
    hl = np.concatenate([np.ones(len(f_h["alt_depth"]), bool), np.zeros(100, bool)])
    ph = clf.predict_proba(hf)
    out["hiv_err381524"] = {
        "n_true": int(hl.sum()),
        "n_junk": int((~hl).sum()),
        "roc_auc": round(roc_auc(hl, ph), 4),
        "accuracy": round(float(((ph >= 0.5) == hl).mean()), 4),
        "true_pass_rate": round(float((ph[hl] >= 0.5).mean()), 4),
    }

    # GT re-genotyper leg
    gt_map = {g: i for i, g in enumerate(GT_CLASSES)}

    def labels_of(recs):
        return np.array(
            [gt_map[str(r.fmt["GT"]).replace("|", "/")] for r in recs]
        )

    y_pos = np.concatenate([labels_of(recs_f), labels_of(recs_m)])
    gt_clf = train_gt_classifier(train_pos, y_pos, seed=seed)
    pred = gt_clf.predict(f_p)
    out["gt_proband"] = {
        "n": len(pred),
        "accuracy": round(float((pred == labels_of(recs_p)).mean()), 4),
    }
    return out


def stack_cols():
    from biograph_jax.classifier.model import FEATURES

    return FEATURES


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    out = compute_metrics()
    path = os.path.join(REPO, "CLASSIFIER_METRICS.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out, indent=1))
    print(f"-> {path}")


if __name__ == "__main__":
    main()
