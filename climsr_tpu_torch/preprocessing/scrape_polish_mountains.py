# -*- coding: utf-8 -*-
"""Scrape Polish mountain-peak lat/lon/alt into a feather probe table: the
port of ``climsr_tpu.preprocessing.scrape_polish_mountains``.

Parity: reference ``climsr/preprocessing/scrape_polish_mountains.py``
(BeautifulSoup scrape of a peaks list). Network access may be unavailable;
``build_fallback_table`` emits the same schema from the built-in
``consts.result_inspection`` coordinates so downstream result inspection
always has a probe table. ``requests`` and bs4 are imported in the call; the
table is a :class:`~climsr_tpu_torch.data.tables.Table`, written by the port's
feather codec.
"""
from __future__ import annotations

import argparse
import logging
from pathlib import Path

import climsr_tpu_torch.consts as consts
from climsr_tpu_torch.data.tables import Table, write_feather

logger = logging.getLogger(__name__)

PEAKS_URL = "https://pl.wikipedia.org/wiki/Lista_najwy%C5%BCszych_szczyt%C3%B3w_w_Polsce"
COLUMNS = ["name", "lat", "lon", "altitude"]


def build_fallback_table() -> Table:
    ri = consts.result_inspection
    return Table(
        {
            "name": [f"peak{i}" for i in range(len(ri.lats))],
            "lat": ri.lats,
            "lon": ri.lons,
            "altitude": ri.alts,
        }
    )


def scrape(url: str = PEAKS_URL) -> Table:
    """Scrape peaks into the SAME schema as the fallback table:
    ``[name, lat, lon, altitude]`` — downstream result inspection reads
    lat/lon columns, so rows whose coordinates can't be parsed are skipped."""
    import re

    import requests
    from bs4 import BeautifulSoup

    resp = requests.get(url, timeout=30)
    resp.raise_for_status()
    soup = BeautifulSoup(resp.text, "html.parser")
    rows = []
    for table in soup.find_all("table", {"class": "wikitable"}):
        for tr in table.find_all("tr")[1:]:
            tds = tr.find_all(["td", "th"])
            if len(tds) < 3:
                continue
            name = tds[0].get_text(strip=True)
            # wiki coordinate microformat: <span class="geo">50.123; 19.456</span>
            geo = tr.find("span", {"class": "geo"})
            if geo is None:
                continue
            m = re.match(r"\s*(-?\d+(?:\.\d+)?)\s*;\s*(-?\d+(?:\.\d+)?)", geo.get_text())
            if not m:
                continue
            lat, lon = float(m.group(1)), float(m.group(2))
            alt = None
            for td in tds[1:]:
                text = td.get_text(strip=True).replace("\xa0", " ")
                # anchor to the "NNNN m" altitude cell so decimal fragments of
                # coordinates / reference numbers in other cells can't match;
                # (?<![\d.,]) rejects the fractional part of e.g. "50.1234"
                am = re.search(r"(?<![\d.,])(\d{3,4})(?:[.,]\d+)?\s*m\b", text)
                if am:
                    alt = float(am.group(1))
                    break
            rows.append((name, lat, lon, alt))
    if not rows:
        raise RuntimeError("No peak rows parsed")
    return Table({c: [r[i] for r in rows] for i, c in enumerate(COLUMNS)})


def main() -> None:
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--out", default="datasets/mountain_peaks.feather")
    parser.add_argument("--offline", action="store_true", help="use the built-in coordinate table")
    args = parser.parse_args()

    if args.offline:
        table = build_fallback_table()
    else:
        try:
            table = scrape()
        except Exception as e:  # the boundary of a network scrape: fall back and say why
            logger.warning("Scrape failed (%s); falling back to built-in coordinates", e)
            table = build_fallback_table()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    write_feather(table, args.out)
    logger.info("Wrote %d peaks to %s", len(table), args.out)


if __name__ == "__main__":
    main()
