"""TPC-H-like schema, data generator and queries (port of
spark_rapids_tpu/benchmarks/tpch.py: `date_lit` :35, `gen_tables` :57-233,
`q1` :237, `q6` :258, `q3` :271 and `q5` :290; the other queries wait for
their slices). q1 and q6 are the reference's BASELINE config 2 (aggregate
and sort over a scan), q3 and q5 its config 3 (broadcast and shuffled hash
joins).

`gen_tables` makes the same random draws in the same order as the
reference, so one seed gives the same rows in both packages. Only the way
the strings are built differs: categorical columns gather a pool of values
(`HostColumnVector.from_pool`, which also encodes them to UTF-8 once) and
formatted ones use numpy's vectorised string functions, so no per-row
Python loop runs at large scale factors. SF 1 ~= 6M lineitem rows. Prices
are DOUBLE, as in the reference.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from spark_rapids_tpu_torch.columnar.batch import HostColumnVector
from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.ops.literals import Literal
from spark_rapids_tpu_torch.plan import functions as F
from spark_rapids_tpu_torch.plan.column import Column

_EPOCH = np.datetime64("1970-01-01", "D")


def _days(s: str) -> int:
    return int((np.datetime64(s, "D") - _EPOCH).astype(int))


def date_lit(s: str) -> Column:
    """A DATE literal from 'YYYY-MM-DD'."""
    return Column(Literal(_days(s), DataType.DATE))


_SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"]
_FLAGS = ["A", "N", "R"]
_STATUS = ["F", "O"]
_REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
_SHIPMODES = ["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK"]
_INSTRUCT = ["COLLECT COD", "DELIVER IN PERSON", "NONE", "TAKE BACK RETURN"]
_PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
_TYPES = ["ECONOMY ANODIZED STEEL", "LARGE BRUSHED BRASS",
          "MEDIUM POLISHED COPPER", "PROMO BURNISHED NICKEL",
          "PROMO PLATED TIN", "SMALL PLATED COPPER", "STANDARD POLISHED TIN"]
_CONTAINERS = ["JUMBO PKG", "LG CASE", "MED BAG", "MED BOX", "MED PACK",
               "MED PKG", "SM BOX", "SM CASE", "SM PACK", "SM PKG"]


def _pick(pool, codes) -> HostColumnVector:
    return HostColumnVector.from_pool(pool, codes)


def _cat(*parts) -> np.ndarray:
    """Row-wise concatenation of str arrays / str constants -> objects."""
    out = np.asarray(parts[0], dtype=str)
    for p in parts[1:]:
        out = np.char.add(out, np.asarray(p, dtype=str))
    return out.astype(object)


def _zfill(values: np.ndarray, width: int) -> np.ndarray:
    return np.char.zfill(values.astype(str), width)


def gen_tables(session, sf: float = 0.001, num_partitions: int = 4,
               seed: int = 0) -> Dict[str, "object"]:
    """Generate the lineitem/orders/customer/supplier/nation/region/part/
    partsupp tables at scale factor `sf` (reference: tpch.py:57)."""
    rng = np.random.default_rng(seed)
    n_li = max(64, int(6_000_000 * sf))
    n_ord = max(32, int(1_500_000 * sf))
    n_cust = max(16, int(150_000 * sf))
    n_supp = max(8, int(10_000 * sf))
    n_nation = 25
    n_part = max(8, int(200_000 * sf))

    ship_lo, ship_hi = _days("1992-01-01"), _days("1998-12-01")
    shipdate = rng.integers(ship_lo, ship_hi, n_li).astype(np.int32)
    commitdate = shipdate + rng.integers(-30, 60, n_li).astype(np.int32)
    receiptdate = shipdate + rng.integers(1, 31, n_li).astype(np.int32)
    lineitem = session.createDataFrame({
        "l_orderkey": rng.integers(0, n_ord, n_li).astype(np.int64),
        "l_partkey": rng.integers(0, n_part, n_li).astype(np.int64),
        "l_suppkey": rng.integers(0, n_supp, n_li).astype(np.int64),
        "l_quantity": rng.integers(1, 51, n_li).astype(np.float64),
        "l_extendedprice": (rng.random(n_li) * 100_000).round(2),
        "l_discount": (rng.integers(0, 11, n_li) / 100.0),
        "l_tax": (rng.integers(0, 9, n_li) / 100.0),
        "l_returnflag": _pick(_FLAGS, rng.integers(0, len(_FLAGS), n_li)),
        "l_linestatus": _pick(_STATUS, rng.integers(0, len(_STATUS), n_li)),
        "l_shipdate": shipdate,
        "l_commitdate": commitdate,
        "l_receiptdate": receiptdate,
        "l_shipmode": _pick(_SHIPMODES,
                            rng.integers(0, len(_SHIPMODES), n_li)),
        "l_shipinstruct": _pick(_INSTRUCT,
                                rng.integers(0, len(_INSTRUCT), n_li)),
    }, [("l_orderkey", "long"), ("l_partkey", "long"), ("l_suppkey", "long"),
        ("l_quantity", "double"), ("l_extendedprice", "double"),
        ("l_discount", "double"), ("l_tax", "double"),
        ("l_returnflag", "string"), ("l_linestatus", "string"),
        ("l_shipdate", DataType.DATE), ("l_commitdate", DataType.DATE),
        ("l_receiptdate", DataType.DATE), ("l_shipmode", "string"),
        ("l_shipinstruct", "string")],
        num_partitions=num_partitions)

    ord_lo, ord_hi = _days("1992-01-01"), _days("1998-08-02")
    comment_pool = ["regular deposits", "special requests sleep",
                    "quick packages", "express special handling requests",
                    "ironic accounts nag"]
    orders = session.createDataFrame({
        "o_orderkey": np.arange(n_ord, dtype=np.int64),
        "o_custkey": rng.integers(0, n_cust, n_ord).astype(np.int64),
        "o_orderdate": rng.integers(ord_lo, ord_hi, n_ord).astype(np.int32),
        "o_shippriority": np.zeros(n_ord, dtype=np.int32),
        "o_orderpriority": _pick(_PRIORITIES,
                                 rng.integers(0, len(_PRIORITIES), n_ord)),
        "o_orderstatus": _pick(["F", "O", "P"], rng.integers(0, 3, n_ord)),
        "o_totalprice": (rng.random(n_ord) * 500_000).round(2),
        "o_comment": _pick(comment_pool,
                           rng.integers(0, len(comment_pool), n_ord)),
    }, [("o_orderkey", "long"), ("o_custkey", "long"),
        ("o_orderdate", DataType.DATE), ("o_shippriority", "int"),
        ("o_orderpriority", "string"), ("o_orderstatus", "string"),
        ("o_totalprice", "double"), ("o_comment", "string")],
        num_partitions=num_partitions)

    colors = ["almond", "azure", "forest", "green", "lime", "navy",
              "plum", "rose", "sienna", "tan"]
    nouns = ["bead", "case", "dust", "ink", "mat", "pad", "tube", "wire"]
    color_codes = rng.integers(0, len(colors), n_part)
    noun_codes = rng.integers(0, len(nouns), n_part)
    part = session.createDataFrame({
        "p_partkey": np.arange(n_part, dtype=np.int64),
        "p_name": _pick([f"{c} {w}" for c in colors for w in nouns],
                        color_codes * len(nouns) + noun_codes),
        "p_mfgr": _pick([f"Manufacturer#{i}" for i in range(1, 6)],
                        rng.integers(1, 6, n_part) - 1),
        "p_type": _pick(_TYPES, rng.integers(0, len(_TYPES), n_part)),
        "p_brand": _pick([f"Brand#{i}" for i in range(11, 56)],
                         rng.integers(11, 56, n_part) - 11),
        "p_container": _pick(_CONTAINERS,
                             rng.integers(0, len(_CONTAINERS), n_part)),
        "p_size": rng.integers(1, 51, n_part).astype(np.int32),
    }, [("p_partkey", "long"), ("p_name", "string"), ("p_mfgr", "string"),
        ("p_type", "string"), ("p_brand", "string"),
        ("p_container", "string"), ("p_size", "int")],
        num_partitions=max(1, num_partitions // 2))

    # 4 suppliers per part (TPC-H spec shape: |partsupp| = 4 * |part|)
    n_ps = 4 * n_part
    partsupp = session.createDataFrame({
        "ps_partkey": np.repeat(np.arange(n_part, dtype=np.int64), 4),
        "ps_suppkey": rng.integers(0, n_supp, n_ps).astype(np.int64),
        "ps_availqty": rng.integers(1, 10_000, n_ps).astype(np.int32),
        "ps_supplycost": (rng.random(n_ps) * 1000).round(2),
    }, [("ps_partkey", "long"), ("ps_suppkey", "long"),
        ("ps_availqty", "int"), ("ps_supplycost", "double")],
        num_partitions=num_partitions)

    phone_codes = np.array(["13", "17", "18", "23", "29", "30", "31", "32",
                            "33"])
    customer = session.createDataFrame({
        "c_custkey": np.arange(n_cust, dtype=np.int64),
        "c_name": _cat("Customer#", _zfill(np.arange(n_cust), 9)),
        "c_mktsegment": _pick(_SEGMENTS,
                              rng.integers(0, len(_SEGMENTS), n_cust)),
        "c_nationkey": rng.integers(0, n_nation, n_cust).astype(np.int64),
        "c_acctbal": (rng.random(n_cust) * 11_000 - 1_000).round(2),
        "c_phone": _cat(
            phone_codes[rng.integers(0, len(phone_codes), n_cust)], "-",
            _zfill(rng.integers(100, 1000, n_cust), 3), "-",
            _zfill(rng.integers(100, 1000, n_cust), 3), "-",
            _zfill(rng.integers(1000, 10_000, n_cust), 4)),
    }, [("c_custkey", "long"), ("c_name", "string"),
        ("c_mktsegment", "string"), ("c_nationkey", "long"),
        ("c_acctbal", "double"), ("c_phone", "string")],
        num_partitions=num_partitions)

    s_comment_pool = ["blithely final accounts", "Customer insults",
                      "Customer kindly Complaints about", "quiet waters",
                      "furious Customer Complaints heard"]
    supp_keys = np.arange(n_supp)
    supplier = session.createDataFrame({
        "s_suppkey": np.arange(n_supp, dtype=np.int64),
        "s_name": _cat("Supplier#", _zfill(supp_keys, 9)),
        "s_address": _pick([f"addr {i}" for i in range(97)],
                           supp_keys % 97),
        "s_nationkey": rng.integers(0, n_nation, n_supp).astype(np.int64),
        "s_acctbal": (rng.random(n_supp) * 11_000 - 1_000).round(2),
        "s_comment": _pick(s_comment_pool,
                           rng.integers(0, len(s_comment_pool), n_supp)),
    }, [("s_suppkey", "long"), ("s_name", "string"),
        ("s_address", "string"), ("s_nationkey", "long"),
        ("s_acctbal", "double"), ("s_comment", "string")],
        num_partitions=max(1, num_partitions // 2))

    nation = session.createDataFrame({
        "n_nationkey": np.arange(n_nation, dtype=np.int64),
        "n_regionkey": (np.arange(n_nation) % len(_REGIONS)).astype(np.int64),
        "n_name": _cat("NATION_", np.arange(n_nation)),
    }, [("n_nationkey", "long"), ("n_regionkey", "long"),
        ("n_name", "string")], num_partitions=1)

    region = session.createDataFrame({
        "r_regionkey": np.arange(len(_REGIONS), dtype=np.int64),
        "r_name": np.array(_REGIONS, dtype=object),
    }, [("r_regionkey", "long"), ("r_name", "string")], num_partitions=1)

    return {"lineitem": lineitem, "orders": orders, "customer": customer,
            "supplier": supplier, "nation": nation, "region": region,
            "part": part, "partsupp": partsupp}


# ---------------------------------------------------------------------------
# queries (reference: Q1Like/Q6Like, TpchLikeSpark.scala)
# ---------------------------------------------------------------------------
def q1(t) -> "object":
    """Pricing summary report (agg + sort)."""
    li = t["lineitem"]
    return (li.filter(li["l_shipdate"] <= date_lit("1998-09-02"))
            .withColumn("disc_price",
                        F.col("l_extendedprice") * (F.lit(1.0) - F.col("l_discount")))
            .withColumn("charge",
                        F.col("l_extendedprice") * (F.lit(1.0) - F.col("l_discount"))
                        * (F.lit(1.0) + F.col("l_tax")))
            .groupBy("l_returnflag", "l_linestatus")
            .agg(F.sum("l_quantity").alias("sum_qty"),
                 F.sum("l_extendedprice").alias("sum_base_price"),
                 F.sum("disc_price").alias("sum_disc_price"),
                 F.sum("charge").alias("sum_charge"),
                 F.avg("l_quantity").alias("avg_qty"),
                 F.avg("l_extendedprice").alias("avg_price"),
                 F.avg("l_discount").alias("avg_disc"),
                 F.count("*").alias("count_order"))
            .orderBy("l_returnflag", "l_linestatus"))


def q6(t) -> "object":
    """Forecasting revenue change (tight filter + keyless reduction)."""
    li = t["lineitem"]
    return (li.filter((li["l_shipdate"] >= date_lit("1994-01-01"))
                      & (li["l_shipdate"] < date_lit("1995-01-01"))
                      & (li["l_discount"] >= F.lit(0.05))
                      & (li["l_discount"] <= F.lit(0.07))
                      & (li["l_quantity"] < F.lit(24.0)))
            .withColumn("revenue",
                        F.col("l_extendedprice") * F.col("l_discount"))
            .agg(F.sum("revenue").alias("revenue")))


def q3(t) -> "object":
    """Shipping priority (3-way join + agg + sort + limit)."""
    c = t["customer"]
    o = t["orders"]
    li = t["lineitem"]
    return (c.filter(c["c_mktsegment"] == F.lit("BUILDING"))
            .join(o, on=(c["c_custkey"] == o["o_custkey"]), how="inner")
            .filter(F.col("o_orderdate") < date_lit("1995-03-15"))
            .join(li.filter(li["l_shipdate"] > date_lit("1995-03-15")),
                  on=(F.col("o_orderkey") == li["l_orderkey"]), how="inner")
            .withColumn("volume",
                        F.col("l_extendedprice") * (F.lit(1.0) - F.col("l_discount")))
            .groupBy("o_orderkey", "o_orderdate", "o_shippriority")
            .agg(F.sum("volume").alias("revenue"))
            .orderBy(F.col("revenue").desc(), F.col("o_orderdate"))
            .limit(10))


def q5(t) -> "object":
    """Local supplier volume (6-way join + agg + sort)."""
    c, o, li = t["customer"], t["orders"], t["lineitem"]
    s, n, r = t["supplier"], t["nation"], t["region"]
    return (r.filter(r["r_name"] == F.lit("ASIA"))
            .join(n, on=(r["r_regionkey"] == n["n_regionkey"]), how="inner")
            .join(s, on=(n["n_nationkey"] == s["s_nationkey"]), how="inner")
            .join(li, on=(s["s_suppkey"] == li["l_suppkey"]), how="inner")
            .join(o.filter((o["o_orderdate"] >= date_lit("1994-01-01"))
                           & (o["o_orderdate"] < date_lit("1995-01-01"))),
                  on=(F.col("l_orderkey") == o["o_orderkey"]), how="inner")
            .join(c, on=(F.col("o_custkey") == c["c_custkey"]), how="inner")
            .filter(F.col("c_nationkey") == F.col("n_nationkey"))
            .withColumn("volume",
                        F.col("l_extendedprice") * (F.lit(1.0) - F.col("l_discount")))
            .groupBy("n_name")
            .agg(F.sum("volume").alias("revenue"))
            .orderBy(F.col("revenue").desc()))


QUERIES = {"q1": q1, "q6": q6, "q3": q3, "q5": q5}
