"""VDB warehouse: filter DSL translation, study checkpoints, anno join,
multi-sample export (reference: python/biograph/vdb/)."""

import pytest

from biograph_jax.tools.vdb import VDB, sort_vcf
from biograph_jax.tools.vdb_filter import FilterError, translate


def _write(path, lines):
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _vcf(path, sample, records, refname="e_coli"):
    """records: (chrom, pos1, ref, alt, qual, filt, info, gt)"""
    lines = [
        "##fileformat=VCFv4.2",
        f"##reference={refname}",
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="GT">',
        '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="DP">',
        f"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t{sample}",
    ]
    for chrom, pos, ref, alt, qual, filt, info, gt in records:
        lines.append(
            f"{chrom}\t{pos}\t.\t{ref}\t{alt}\t{qual}\t{filt}\t{info}\tGT:DP\t{gt}:9"
        )
    return _write(path, lines)


# ---------------- filter DSL ----------------


def test_translate_basics():
    assert translate("qual > 50") == "qual > 50"
    assert translate("chrom == '1'") == "chrom = '1'"
    # PosFix: VCF 1-based literals -> stored 0-based
    assert translate("pos >= 100") == "pos >= 99"
    # QuoteFix: bareword RHS of a string column
    assert translate("chrom = chr1") == "chrom = 'chr1'"
    assert translate("filter != PASS") == "filt != 'PASS'"
    # id -> varid
    assert translate("id = 'rs42'") == "varid = 'rs42'"


def test_translate_fields_and_logic():
    assert (
        translate("GT = 0/1 && qual > 9")
        == "json_extract(sample, '$.GT') = '0/1' AND qual > 9"
    )
    assert translate("DP >= 10") == "CAST(json_extract(sample, '$.DP') AS INTEGER) >= 10"
    assert translate("SVLEN < -49") == "CAST(json_extract(info, '$.SVLEN') AS INTEGER) < - 49"
    assert translate("info/FOO = 'x'") == "json_extract(info, '$.FOO') = 'x'"
    assert translate("fmt/GT != 1/1") == "json_extract(sample, '$.GT') != '1/1'"
    # ',' is OR; '!' is NOT (filter.py Logical)
    assert translate("qual > 1, qual < 0") == "qual > 1 OR qual < 0"
    # '.' is NULL
    assert translate("id = '.'") == "varid IS NULL"
    assert translate("qual != '.'") == "qual IS NOT NULL"
    # derived columns
    assert translate("reflen > 3") == "LENGTH(ref) > 3"
    assert translate("STRLEN ( alt ) > 5") == "LENGTH ( alt ) > 5"


def test_translate_rejects_typos():
    with pytest.raises(FilterError):
        translate("qualz > 50")
    with pytest.raises(FilterError):
        translate("fmt/NOTAFIELD = 1")


# ---------------- warehouse lifecycle ----------------


@pytest.fixture
def db(tmp_path):
    v = VDB(str(tmp_path / "vdb"))
    yield v
    v.close()


def _load_two_samples(db, tmp_path):
    a1, n1 = db.import_vcf(
        _vcf(
            tmp_path / "a.vcf",
            "HG002",
            [
                ("1", 100, "A", "T", 50, "PASS", "SVTYPE=SNP", "0/1"),
                ("1", 200, "G", "C", 9, "lowq", ".", "1/1"),
                ("2", 5, "T", "TA", 99, "PASS", "SVLEN=1", "0/1"),
            ],
        )
    )
    a2, n2 = db.import_vcf(
        _vcf(
            tmp_path / "b.vcf",
            "HG003",
            [
                ("1", 100, "A", "T", 77, "PASS", "SVTYPE=SNP", "1/1"),
                ("2", 300, "C", "G", 31, "PASS", ".", "0/1"),
            ],
        )
    )
    assert (n1, n2) == (3, 2)
    return a1, a2


def test_vcf_group(db, tmp_path):
    a1, _ = _load_two_samples(db, tmp_path)
    lst = db.list_vcfs()
    assert [r["sample_name"] for r in lst] == ["HG002", "HG003"]
    assert lst[0]["refname"] == "e_coli"
    out = tmp_path / "x.vcf"
    assert db.export_vcf(a1, str(out)) == 3
    text = out.read_text()
    assert "0/1:9" in text and text.count("\n") > 3
    assert db.delete_vcf(a1) == 1
    assert [r["sample_name"] for r in db.list_vcfs()] == ["HG003"]


def test_study_lifecycle(db, tmp_path):
    _load_two_samples(db, tmp_path)
    db.create_study("fam")
    with pytest.raises(ValueError):
        db.create_study("fam")
    # wildcard add creates checkpoint 1 with both samples
    assert db.add_to_study("fam", ["HG00*"]) == 1
    show = db.show_study("fam")
    assert show["checkpoint"] == 1
    assert show["samples"] == [("HG002", 3), ("HG003", 2)]
    # filter to PASS only -> checkpoint 2
    cp, kept = db.filter_study("fam", "filter != PASS", exclude=True)
    assert (cp, kept) == (2, 4)
    # include-style filter -> checkpoint 3
    cp, kept = db.filter_study("fam", "qual > 40")
    assert (cp, kept) == (3, 3)
    # revert one checkpoint
    assert db.revert_study("fam") == 2
    assert db.current_checkpoint("fam") == 2
    # freeze blocks mutation
    db.freeze_study("fam")
    with pytest.raises(ValueError):
        db.add_to_study("fam", ["HG002"])
    db.freeze_study("fam", frozen=False)
    # copy into a second study at a chosen checkpoint
    db.create_study("fam2")
    db.copy_from_study("fam", 1, "fam2", ["HG003"])
    assert db.show_study("fam2")["samples"] == [("HG003", 2)]
    db.delete_study("fam2")
    assert not db._study_exists("fam2")


def test_study_export_multisample(db, tmp_path):
    _load_two_samples(db, tmp_path)
    db.create_study("s")
    db.add_to_study("s", ["HG002", "HG003"])
    out = tmp_path / "m.vcf"
    assert db.export_study("s", str(out)) == 4  # 4 distinct sites
    lines = [l for l in out.read_text().splitlines() if not l.startswith("#")]
    head = [l for l in out.read_text().splitlines() if l.startswith("#CHROM")][0]
    assert head.endswith("HG002\tHG003")
    # shared site 1:100 carries both GTs; HG003-only site shows ./.
    site100 = [l for l in lines if l.split("\t")[1] == "100"][0]
    assert "0/1" in site100 and "1/1" in site100
    site300 = [l for l in lines if l.split("\t")[1] == "300"][0]
    assert "./." in site300
    # square-off: single sample column over the union of sites
    out2 = tmp_path / "sq.vcf"
    db.export_study("s", str(out2), square_off="HG003")
    head2 = [l for l in out2.read_text().splitlines() if l.startswith("#CHROM")][0]
    assert head2.endswith("HG003") and "HG002" not in head2
    assert sum(1 for l in out2.read_text().splitlines() if not l.startswith("#")) == 4


def test_study_missingness_filter(db, tmp_path):
    _load_two_samples(db, tmp_path)
    db.create_study("m")
    db.add_to_study("m", ["HG002", "HG003"])
    # site 1:100 is present in both samples -> F_MISS 0; others miss one of
    # two samples -> F_MISS 0.5
    cp, kept = db.filter_study("m", "F_MISS > 0.4", exclude=True)
    assert kept == 2  # both rows of site 1:100


def test_anno_join(db, tmp_path):
    _load_two_samples(db, tmp_path)
    db.import_anno(
        _vcf(
            tmp_path / "anno.vcf",
            "ANNO",
            [("1", 100, "A", "T", 1, ".", "GENE=thrA;DB=1", "0/0")],
        ),
        name="genes",
    )
    assert db.list_annos()[0]["anno_name"] == "genes"
    # anno export round-trip (anno_cmd.py cmd_export analog)
    aout = tmp_path / "anno_out.vcf"
    assert db.export_anno("genes", str(aout)) == 1
    assert "GENE=thrA" in aout.read_text()
    db.create_study("a")
    db.add_to_study("a", ["HG002"])
    out = tmp_path / "a.vcf"
    db.export_study("a", str(out), anno="genes")
    lines = [l for l in out.read_text().splitlines() if "\t100\t" in l]
    assert lines and "GENE=thrA" in lines[0]


def test_mixed_reference_rejected(db, tmp_path):
    db.import_vcf(
        _vcf(tmp_path / "r1.vcf", "S1", [("1", 1, "A", "T", 9, "PASS", ".", "0/1")])
    )
    db.import_vcf(
        _vcf(
            tmp_path / "r2.vcf",
            "S2",
            [("1", 2, "C", "G", 9, "PASS", ".", "0/1")],
            refname="grch38",
        )
    )
    db.create_study("x")
    with pytest.raises(ValueError):
        db.add_to_study("x", ["S1", "S2"])


def test_cli_groups(db, tmp_path, capsys):
    """The vdb vcf/study/query/sort CLI surface end-to-end (in-process)."""
    from biograph_jax.cli import main

    vcf = _vcf(
        tmp_path / "cli.vcf",
        "HG002",
        [
            ("1", 100, "A", "T", 50, "PASS", "SVTYPE=SNP", "0/1"),
            ("1", 200, "G", "C", 9, "lowq", ".", "1/1"),
        ],
    )
    d = str(tmp_path / "clidb")
    main(["vdb", "vcf", "import", "--db", d, vcf])
    aid = capsys.readouterr().out.split("\t")[0]
    main(["vdb", "vcf", "list", "--db", d])
    assert "HG002" in capsys.readouterr().out
    main(["vdb", "study", "create", "--db", d, "fam"])
    main(["vdb", "study", "add", "--db", d, "fam", "HG00*"])
    main(["vdb", "study", "filter", "--db", d, "fam", "-e", "filter != PASS"])
    capsys.readouterr()
    main(["vdb", "study", "show", "--db", d, "fam"])
    out = capsys.readouterr().out
    assert "checkpoint: 2" in out and "HG002            1" in out
    ovcf = str(tmp_path / "cli_out.vcf")
    main(["vdb", "study", "export", "--db", d, "fam", "-o", ovcf])
    recs = [l for l in open(ovcf) if not l.startswith("#")]
    assert len(recs) == 1 and recs[0].split("\t")[1] == "100"
    main(["vdb", "query", "--db", d, "SELECT COUNT(*) FROM variants"])
    assert capsys.readouterr().out.strip().endswith("2")
    main(["vdb", "vcf", "export", "--db", d, "-a", aid, "-o", str(tmp_path / "e.vcf")])
    assert sum(1 for l in open(tmp_path / "e.vcf") if not l.startswith("#")) == 2


def test_raw_query_and_sort(db, tmp_path):
    _load_two_samples(db, tmp_path)
    rows = db.query(
        "SELECT sample_name, COUNT(*) FROM variants GROUP BY sample_name"
        " ORDER BY sample_name"
    )
    assert rows == [("HG002", 3), ("HG003", 2)]
    with pytest.raises(ValueError):
        db.query("DELETE FROM variants")
    # natural-order sort: chr2 < chr10 (alphabetic would invert)
    vcf = _vcf(
        tmp_path / "u.vcf",
        "S",
        [
            ("chr10", 5, "A", "T", 9, "PASS", ".", "0/1"),
            ("chr2", 9, "C", "G", 9, "PASS", ".", "0/1"),
        ],
    )
    out = tmp_path / "sorted.vcf"
    assert sort_vcf(vcf, str(out), chromosomal=True) == 2
    recs = [l.split("\t")[0] for l in out.read_text().splitlines() if not l.startswith("#")]
    assert recs == ["chr2", "chr10"]


def test_filter_fuzz_translates_to_valid_sql(db, tmp_path):
    """Every grammar-valid expression must either translate to SQL sqlite
    accepts, or raise FilterError — never produce broken SQL (the
    reference's parser-enforced same guarantee)."""
    import random
    import sqlite3

    _load_two_samples(db, tmp_path)
    rng = random.Random(11)
    fields = [
        "chrom", "pos", "ref", "alt", "qual", "filter", "id", "varid",
        "varend", "reflen", "spans", "sample_name", "aid",
        "GT", "DP", "GQ", "PL", "SVLEN", "SVTYPE", "info/FOO", "fmt/DP",
    ]
    cmps = ["=", "==", "!=", ">", ">=", "<", "<="]
    strings = ["'PASS'", '"chr1"', "'.'", "'1'"]
    logicals = ["AND", "OR", "&&", "||", ","]

    def atom():
        f = rng.choice(fields)
        c = rng.choice(cmps)
        r = rng.random()
        if f in ("GT", "fmt/GT"):
            rhs = rng.choice(["0/1", "1/1", "0|1", "'./.'"])
            c = rng.choice(["=", "!="])
        elif r < 0.4:
            rhs = str(rng.randint(0, 500))
        elif r < 0.7:
            rhs = rng.choice(strings)
            c = rng.choice(["=", "!="]) if rhs == "'.'" else c
        else:
            rhs = f"{rng.randint(1, 50)} + {rng.randint(1, 9)}"
        return f"{f} {c} {rhs}"

    from biograph_jax.tools.vdb_filter import FilterError, translate

    n_ok = 0
    for _ in range(300):
        n = rng.randint(1, 4)
        parts = [atom()]
        for _ in range(n - 1):
            parts.append(rng.choice(logicals))
            parts.append(atom())
        expr = " ".join(parts)
        if rng.random() < 0.3:
            expr = f"( {expr} )"
        try:
            sql = translate(expr)
        except FilterError:
            continue
        # must be executable against the variants table
        try:
            db.conn.execute(f"SELECT COUNT(*) FROM variants WHERE {sql}")
        except sqlite3.Error as e:
            raise AssertionError(f"{expr!r} -> {sql!r}: {e}")
        n_ok += 1
    assert n_ok > 200  # the grammar above is overwhelmingly valid
