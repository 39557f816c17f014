"""TLI builder CLI — the pylineread equivalent (this package's own host
copy of bart_tpu/linelist/lineread.py).

Reads the reference's pylineread config format unchanged (reference:
examples/demo/pyline_demo.cfg — [Parameters] section with db_list /
part_list / dbtype / output / iwav / fwav) plus the modern 'exomol'
dbtype, and writes a TLI artifact (linelist/tli.py):

    python -m bart_tpu_torch.linelist.lineread -c pyline_demo.cfg

dbtypes: hit (HITRAN/HITEMP .par), ps (Partridge-Schwenke H2O binary),
ts (Schwenke TiO binary), vo (Plez VO ASCII), exomol
(states_file:trans_file[:pf_file] triplet in db_list).
"""

from __future__ import annotations

import argparse
import configparser
import sys

import numpy as np

from bart_tpu_torch.linelist.hitran import LineList, read_par
from bart_tpu_torch.linelist.tli import TliData, save_tli

__all__ = ["build_tli", "main"]


def _read_part(path: str | None):
    if path in (None, "implicit"):
        return None
    from bart_tpu_torch.linelist.kurucz_mol import read_kurucz_partition

    # handles plain 2-column (T, Q) tables and the Kurucz multi-isotope
    # ASCII tables (h2opartfn.dat / tiopart.dat) with text headers
    return read_kurucz_partition(path)


def build_tli(
    db_list: list[str],
    dbtypes: list[str],
    part_list: list[str] | None,
    output: str,
    iwav_um: float,
    fwav_um: float,
    species_hint: list[str] | None = None,
) -> TliData:
    """Parse every database, merge per species, sort by wavenumber,
    trim to [iwav, fwav] microns, and save (pylineread semantics,
    SURVEY.md 3.5)."""
    wn_min = 1e4 / fwav_um
    wn_max = 1e4 / iwav_um
    if part_list is None:
        part_list = ["implicit"] * len(db_list)
    if len(dbtypes) == 1 and len(db_list) > 1:
        dbtypes = dbtypes * len(db_list)

    per_species: dict[str, list[LineList]] = {}
    partition: dict[str, tuple] = {}
    for k, (db, typ) in enumerate(zip(db_list, dbtypes)):
        pf = _read_part(part_list[k] if k < len(part_list) else None)
        hint = (species_hint or [None] * len(db_list))[k]
        if typ == "hit":
            lists = read_par(db)
            for name, ll in lists.items():
                per_species.setdefault(name, []).append(
                    ll.trim(wn_min, wn_max)
                )
                if pf is not None:
                    partition[name] = pf
        elif typ in ("ps", "ts"):
            from bart_tpu_torch.linelist.kurucz_mol import (
                read_ps_binary, read_tio_binary,
            )

            if typ == "ps":
                name = hint or "H2O"
                ll = read_ps_binary(db, name, wn_min, wn_max, pf)
            else:
                name = hint or "TiO"
                ll = read_tio_binary(db, name, wn_min, wn_max, pf)
            per_species.setdefault(name, []).append(ll)
            if pf is not None:
                partition[name] = pf
        elif typ == "vo":
            from bart_tpu_torch.linelist.kurucz_mol import read_plez_vo

            name = hint or "VO"
            ll = read_plez_vo(db, name, wn_min, wn_max, pf)
            per_species.setdefault(name, []).append(ll)
            if pf is not None:
                partition[name] = pf
        elif typ == "exomol":
            from bart_tpu_torch.linelist.exomol import read_exomol

            parts = db.split(":")
            states, trans = parts[0], parts[1]
            pfp = parts[2] if len(parts) > 2 else None
            name = hint or "H2O"
            ll = read_exomol(states, trans, name, pfp, wn_min, wn_max)
            per_species.setdefault(name, []).append(ll)
        else:
            raise ValueError(f"unknown dbtype {typ!r}")

    lines = {
        name: LineList.concatenate(parts) for name, parts in per_species.items()
    }
    data = TliData(list(lines), lines, wn_min, wn_max, partition)
    if output:
        save_tli(data, output)
    return data


def validate(db_list, dbtypes, part_list, iwav_um, fwav_um,
             species_hint=None) -> int:
    """--validate dry run: parse every database tolerantly, print
    per-file diagnostics (record counts, tolerated format deviations,
    dropped records with line numbers, wn coverage vs the requested
    range), build nothing.  Returns a process exit code: 0 clean,
    1 if any record was dropped or a file failed outright."""
    from bart_tpu_torch.linelist.hitran import ParseReport, parse_par_bytes

    wn_min, wn_max = 1e4 / fwav_um, 1e4 / iwav_um
    if len(dbtypes) == 1 and len(db_list) > 1:
        dbtypes = dbtypes * len(db_list)
    rc = 0
    print(f"requested range: {iwav_um}-{fwav_um} um "
          f"({wn_min:.1f}-{wn_max:.1f} cm-1)")
    for k, (db, typ) in enumerate(zip(db_list, dbtypes)):
        print(f"\n[{k + 1}/{len(db_list)}] {typ}: {db}")
        try:
            if typ == "hit":
                rep = ParseReport(path=db)
                with open(db, "rb") as f:
                    lists = parse_par_bytes(f.read(), on_error="skip",
                                            report=rep)
                print(rep.summary())
                if rep.bad_records:
                    rc = 1
            else:
                # binary/columnar formats: a record either parses or
                # the driver raises — exercise the real parse path
                single = build_tli([db], [typ],
                                   [part_list[k]] if k < len(part_list)
                                   else None,
                                   output="", iwav_um=iwav_um,
                                   fwav_um=fwav_um,
                                   species_hint=[
                                       (species_hint or [None] *
                                        len(db_list))[k]])
                lists = single.lines
            for name, ll in lists.items():
                n_in = int(np.count_nonzero(
                    (ll.wn0 >= wn_min) & (ll.wn0 <= wn_max)))
                cover = ("no overlap with requested range"
                         if n_in == 0 else f"{n_in} in range")
                print(f"  {name}: {ll.nlines} lines, "
                      f"{ll.wn0.min():.2f}-{ll.wn0.max():.2f} cm-1 "
                      f"({cover})")
                if n_in == 0:
                    rc = 1
            pf = part_list[k] if k < len(part_list) else None
            if pf not in (None, "implicit"):
                try:
                    _read_part(pf)
                    print(f"  partition table OK: {pf}")
                except Exception as e:
                    print(f"  partition table FAILED: {pf}: {e}")
                    rc = 1
        except Exception as e:
            print(f"  FAILED: {type(e).__name__}: {e}")
            rc = 1
    print("\nvalidate:", "clean" if rc == 0 else
          "issues found (see above)")
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="bart_tpu_torch.linelist.lineread",
        description="Build a TLI line database (pylineread equivalent)",
    )
    ap.add_argument("-c", "--config_file", required=True)
    ap.add_argument("--validate", action="store_true",
                    help="dry run: parse every database with tolerant "
                         "diagnostics and report per-record issues "
                         "without building the TLI")
    args = ap.parse_args(argv)

    cp = configparser.ConfigParser()
    cp.optionxform = str
    cp.read([args.config_file])
    P = dict(cp.items("Parameters"))

    db_list = P["db_list"].split()
    dbtypes = P["dbtype"].split()
    part = P.get("part_list", "implicit").split()
    part = [None if p == "implicit" else p for p in part]
    hint = P.get("species", "").split() or None
    if args.validate:
        return validate(db_list, dbtypes, part,
                        float(P["iwav"]), float(P["fwav"]),
                        species_hint=hint)
    out = P["output"]
    if not out.endswith(".npz"):
        out = out + ".npz"
    data = build_tli(
        db_list, dbtypes, part, out,
        float(P["iwav"]), float(P["fwav"]),
        species_hint=hint,
    )
    print(f"TLI written: {out} — {data.total_lines()} lines, "
          f"species {data.species}, {data.wn_min:.1f}-{data.wn_max:.1f} cm-1")
    return 0


if __name__ == "__main__":
    sys.exit(main())
