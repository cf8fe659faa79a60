"""TPC-H-like schema, data generator and queries (port of
spark_rapids_tpu/benchmarks/tpch.py: `date_lit` :35, `gen_tables` :57-233
and all 22 queries, `q1` :237 to `q22` :729, with the reference's text).
q1 and q6 are the reference's BASELINE config 2 (aggregate and sort over a
scan), q3 and q5 its config 3 (broadcast and shuffled hash joins).

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
_O_COMMENTS = ["regular deposits", "special requests sleep",
               "quick packages", "express special handling requests",
               "ironic accounts nag"]
_S_COMMENTS = ["blithely final accounts", "Customer insults",
               "Customer kindly Complaints about", "quiet waters",
               "furious Customer Complaints heard"]


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
    orders = session.createDataFrame({
        "o_orderkey": np.arange(n_ord, dtype=np.int64),
        "o_custkey": rng.integers(0, n_cust, n_ord).astype(np.int64),
        "o_orderdate": rng.integers(ord_lo, ord_hi, n_ord).astype(np.int32),
        "o_shippriority": np.zeros(n_ord, dtype=np.int32),
        "o_orderpriority": _pick(_PRIORITIES,
                                 rng.integers(0, len(_PRIORITIES), n_ord)),
        "o_orderstatus": _pick(["F", "O", "P"], rng.integers(0, 3, n_ord)),
        "o_totalprice": (rng.random(n_ord) * 500_000).round(2),
        "o_comment": _pick(_O_COMMENTS,
                           rng.integers(0, len(_O_COMMENTS), n_ord)),
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

    supp_keys = np.arange(n_supp)
    supplier = session.createDataFrame({
        "s_suppkey": np.arange(n_supp, dtype=np.int64),
        "s_name": _cat("Supplier#", _zfill(supp_keys, 9)),
        "s_address": _pick([f"addr {i}" for i in range(97)],
                           supp_keys % 97),
        "s_nationkey": rng.integers(0, n_nation, n_supp).astype(np.int64),
        "s_acctbal": (rng.random(n_supp) * 11_000 - 1_000).round(2),
        "s_comment": _pick(_S_COMMENTS,
                           rng.integers(0, len(_S_COMMENTS), n_supp)),
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
# queries (reference: Q1Like .. Q22Like, TpchLikeSpark.scala)
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


def q4(t) -> "object":
    """Order priority checking (EXISTS -> left-semi join + agg)."""
    o, li = t["orders"], t["lineitem"]
    late = li.filter(li["l_commitdate"] < li["l_receiptdate"])
    return (o.filter((o["o_orderdate"] >= date_lit("1993-07-01"))
                     & (o["o_orderdate"] < date_lit("1993-10-01")))
            .join(late, on=(o["o_orderkey"] == late["l_orderkey"]),
                  how="left_semi")
            .groupBy("o_orderpriority")
            .agg(F.count("*").alias("order_count"))
            .orderBy("o_orderpriority"))


def q10(t) -> "object":
    """Returned item reporting (4-way join + agg + sort + limit)."""
    c, o, li, n = t["customer"], t["orders"], t["lineitem"], t["nation"]
    return (c.join(o.filter((o["o_orderdate"] >= date_lit("1993-10-01"))
                            & (o["o_orderdate"] < date_lit("1994-01-01"))),
                   on=(c["c_custkey"] == o["o_custkey"]), how="inner")
            .join(li.filter(li["l_returnflag"] == F.lit("R")),
                  on=(F.col("o_orderkey") == li["l_orderkey"]), how="inner")
            .join(n, on=(F.col("c_nationkey") == n["n_nationkey"]),
                  how="inner")
            .withColumn("volume",
                        F.col("l_extendedprice")
                        * (F.lit(1.0) - F.col("l_discount")))
            .groupBy("c_custkey", "n_name")
            .agg(F.sum("volume").alias("revenue"))
            .orderBy(F.col("revenue").desc(), F.col("c_custkey"))
            .limit(20))


def q12(t) -> "object":
    """Shipping modes and order priority (join + conditional counts)."""
    o, li = t["orders"], t["lineitem"]
    flt = li.filter(
        li["l_shipmode"].isin("MAIL", "SHIP")
        & (li["l_commitdate"] < li["l_receiptdate"])
        & (li["l_shipdate"] < li["l_commitdate"])
        & (li["l_receiptdate"] >= date_lit("1994-01-01"))
        & (li["l_receiptdate"] < date_lit("1995-01-01")))
    high = F.when(F.col("o_orderpriority").isin("1-URGENT", "2-HIGH"),
                  F.lit(1)).otherwise(F.lit(0))
    low = F.when(F.col("o_orderpriority").isin("1-URGENT", "2-HIGH"),
                 F.lit(0)).otherwise(F.lit(1))
    return (o.join(flt, on=(o["o_orderkey"] == flt["l_orderkey"]),
                   how="inner")
            .withColumn("high_line", high)
            .withColumn("low_line", low)
            .groupBy("l_shipmode")
            .agg(F.sum("high_line").alias("high_line_count"),
                 F.sum("low_line").alias("low_line_count"))
            .orderBy("l_shipmode"))


def q14(t) -> "object":
    """Promotion effect (join + conditional aggregate ratio)."""
    li, p = t["lineitem"], t["part"]
    return (li.filter((li["l_shipdate"] >= date_lit("1995-09-01"))
                      & (li["l_shipdate"] < date_lit("1995-10-01")))
            .join(p, on=(li["l_partkey"] == p["p_partkey"]), how="inner")
            .withColumn("volume",
                        F.col("l_extendedprice")
                        * (F.lit(1.0) - F.col("l_discount")))
            .withColumn("promo",
                        F.when(F.col("p_type").startswith("PROMO"),
                               F.col("volume")).otherwise(F.lit(0.0)))
            .agg(F.sum("promo").alias("promo_revenue"),
                 F.sum("volume").alias("total_revenue"))
            .withColumn("promo_pct",
                        F.lit(100.0) * F.col("promo_revenue")
                        / F.col("total_revenue"))
            .select("promo_pct"))


def q19(t) -> "object":
    """Discounted revenue (join + OR-of-ANDs predicate on both sides)."""
    li, p = t["lineitem"], t["part"]
    j = li.filter(li["l_shipinstruct"] == F.lit("DELIVER IN PERSON")).join(
        p, on=(li["l_partkey"] == p["p_partkey"]), how="inner")
    cond = (
        (F.col("p_container").isin("SM CASE", "SM BOX", "SM PACK", "SM PKG")
         & (F.col("l_quantity") >= F.lit(1.0))
         & (F.col("l_quantity") <= F.lit(11.0))
         & (F.col("p_size") <= F.lit(5)))
        | (F.col("p_container").isin("MED BAG", "MED BOX", "MED PKG",
                                     "MED PACK")
           & (F.col("l_quantity") >= F.lit(10.0))
           & (F.col("l_quantity") <= F.lit(20.0))
           & (F.col("p_size") <= F.lit(10)))
        | (F.col("p_container").isin("LG CASE", "JUMBO PKG")
           & (F.col("l_quantity") >= F.lit(20.0))
           & (F.col("l_quantity") <= F.lit(30.0))
           & (F.col("p_size") <= F.lit(15))))
    return (j.filter(cond)
            .withColumn("revenue",
                        F.col("l_extendedprice")
                        * (F.lit(1.0) - F.col("l_discount")))
            .agg(F.sum("revenue").alias("revenue")))


def q2(t) -> "object":
    """Minimum cost supplier (correlated min-subquery -> agg + join-back;
    reference: Q2Like, TpchLikeSpark.scala)."""
    p, ps, s = t["part"], t["partsupp"], t["supplier"]
    n, r = t["nation"], t["region"]
    europe = (r.filter(r["r_name"] == F.lit("EUROPE"))
              .join(n, on=(r["r_regionkey"] == n["n_regionkey"]),
                    how="inner")
              .join(s, on=(F.col("n_nationkey") == s["s_nationkey"]),
                    how="inner")
              .join(ps, on=(F.col("s_suppkey") == ps["ps_suppkey"]),
                    how="inner"))
    # p_size <= 15 (not == 15) keeps the join non-degenerate at SF-tiny
    brass = p.filter((p["p_size"] <= F.lit(15))
                     & p["p_type"].endswith("BRASS"))
    joined = brass.join(europe,
                        on=(brass["p_partkey"] == F.col("ps_partkey")),
                        how="inner")
    min_cost = (joined.groupBy("p_partkey")
                .agg(F.min("ps_supplycost").alias("min_cost"))
                .select(F.col("p_partkey").alias("mc_partkey"),
                        F.col("min_cost")))
    return (joined.join(
        min_cost,
        on=((F.col("p_partkey") == F.col("mc_partkey"))
            & (F.col("ps_supplycost") == F.col("min_cost"))), how="inner")
        .select("s_acctbal", "s_name", "n_name", "p_partkey", "p_mfgr")
        .orderBy(F.col("s_acctbal").desc(), F.col("n_name"),
                 F.col("s_name"), F.col("p_partkey"))
        .limit(100))


def q7(t) -> "object":
    """Volume shipping between two nations (6-way join + year extract;
    reference: Q7Like)."""
    li, o, c, s, n = (t["lineitem"], t["orders"], t["customer"],
                      t["supplier"], t["nation"])
    n1 = n.select(F.col("n_nationkey").alias("sn_key"),
                  F.col("n_name").alias("supp_nation"))
    n2 = n.select(F.col("n_nationkey").alias("cn_key"),
                  F.col("n_name").alias("cust_nation"))
    a, b = "NATION_1", "NATION_2"
    pair = (((F.col("supp_nation") == F.lit(a))
             & (F.col("cust_nation") == F.lit(b)))
            | ((F.col("supp_nation") == F.lit(b))
               & (F.col("cust_nation") == F.lit(a))))
    return (s.join(n1, on=(s["s_nationkey"] == F.col("sn_key")),
                   how="inner")
            .join(li.filter((li["l_shipdate"] >= date_lit("1995-01-01"))
                            & (li["l_shipdate"] <= date_lit("1996-12-31"))),
                  on=(F.col("s_suppkey") == li["l_suppkey"]), how="inner")
            .join(o, on=(F.col("l_orderkey") == o["o_orderkey"]),
                  how="inner")
            .join(c, on=(F.col("o_custkey") == c["c_custkey"]), how="inner")
            .join(n2, on=(F.col("c_nationkey") == F.col("cn_key")),
                  how="inner")
            .filter(pair)
            .withColumn("l_year", F.year(F.col("l_shipdate")))
            .withColumn("volume",
                        F.col("l_extendedprice")
                        * (F.lit(1.0) - F.col("l_discount")))
            .groupBy("supp_nation", "cust_nation", "l_year")
            .agg(F.sum("volume").alias("revenue"))
            .orderBy("supp_nation", "cust_nation", "l_year"))


def q8(t) -> "object":
    """National market share (7-way join + conditional share ratio;
    reference: Q8Like)."""
    li, o, c, s, p = (t["lineitem"], t["orders"], t["customer"],
                      t["supplier"], t["part"])
    n, r = t["nation"], t["region"]
    n1 = n.select(F.col("n_nationkey").alias("cn_key"),
                  F.col("n_regionkey").alias("cn_region"))
    n2 = n.select(F.col("n_nationkey").alias("sn_key"),
                  F.col("n_name").alias("nation"))
    return (p.filter(p["p_type"] == F.lit("ECONOMY ANODIZED STEEL"))
            .join(li, on=(p["p_partkey"] == li["l_partkey"]), how="inner")
            .join(t["supplier"],
                  on=(F.col("l_suppkey") == s["s_suppkey"]), how="inner")
            .join(o.filter((o["o_orderdate"] >= date_lit("1995-01-01"))
                           & (o["o_orderdate"] <= date_lit("1996-12-31"))),
                  on=(F.col("l_orderkey") == o["o_orderkey"]), how="inner")
            .join(c, on=(F.col("o_custkey") == c["c_custkey"]), how="inner")
            .join(n1, on=(F.col("c_nationkey") == F.col("cn_key")),
                  how="inner")
            .join(r.filter(r["r_name"] == F.lit("AMERICA")),
                  on=(F.col("cn_region") == r["r_regionkey"]), how="inner")
            .join(n2, on=(F.col("s_nationkey") == F.col("sn_key")),
                  how="inner")
            .withColumn("o_year", F.year(F.col("o_orderdate")))
            .withColumn("volume",
                        F.col("l_extendedprice")
                        * (F.lit(1.0) - F.col("l_discount")))
            .withColumn("nat_volume",
                        F.when(F.col("nation") == F.lit("NATION_3"),
                               F.col("volume")).otherwise(F.lit(0.0)))
            .groupBy("o_year")
            .agg(F.sum("nat_volume").alias("nat_rev"),
                 F.sum("volume").alias("total_rev"))
            .withColumn("mkt_share", F.col("nat_rev") / F.col("total_rev"))
            .select("o_year", "mkt_share")
            .orderBy("o_year"))


def q9(t) -> "object":
    """Product type profit measure (6-way join incl. 2-key partsupp join;
    reference: Q9Like)."""
    li, o, s, p, ps, n = (t["lineitem"], t["orders"], t["supplier"],
                          t["part"], t["partsupp"], t["nation"])
    return (p.filter(p["p_name"].contains("green"))
            .join(li, on=(p["p_partkey"] == li["l_partkey"]), how="inner")
            .join(s, on=(F.col("l_suppkey") == s["s_suppkey"]), how="inner")
            .join(ps, on=((F.col("l_suppkey") == ps["ps_suppkey"])
                          & (F.col("l_partkey") == ps["ps_partkey"])),
                  how="inner")
            .join(o, on=(F.col("l_orderkey") == o["o_orderkey"]),
                  how="inner")
            .join(n, on=(F.col("s_nationkey") == n["n_nationkey"]),
                  how="inner")
            .withColumn("o_year", F.year(F.col("o_orderdate")))
            .withColumn("amount",
                        F.col("l_extendedprice")
                        * (F.lit(1.0) - F.col("l_discount"))
                        - F.col("ps_supplycost") * F.col("l_quantity"))
            .groupBy("n_name", "o_year")
            .agg(F.sum("amount").alias("sum_profit"))
            .orderBy(F.col("n_name"), F.col("o_year").desc()))


def q11(t) -> "object":
    """Important stock identification (agg vs global-threshold scalar via
    cross join; reference: Q11Like)."""
    ps, s, n = t["partsupp"], t["supplier"], t["nation"]
    base = (ps.join(s, on=(ps["ps_suppkey"] == s["s_suppkey"]), how="inner")
            .join(n.filter(n["n_name"] == F.lit("NATION_7")),
                  on=(F.col("s_nationkey") == n["n_nationkey"]),
                  how="inner")
            .withColumn("value",
                        F.col("ps_supplycost") * F.col("ps_availqty")))
    grouped = base.groupBy("ps_partkey").agg(F.sum("value").alias("pvalue"))
    threshold = base.agg(
        (F.sum("value") * F.lit(0.0001)).alias("threshold"))
    return (grouped.crossJoin(threshold)
            .filter(F.col("pvalue") > F.col("threshold"))
            .select("ps_partkey", "pvalue")
            .orderBy(F.col("pvalue").desc()))


def q13(t) -> "object":
    """Customer order-count distribution (outer join + double agg;
    reference: Q13Like). The %special%requests% LIKE is expressed as two
    contains (the device LIKE subset excludes multi-%% patterns,
    columnar/strings.py:classify_like)."""
    c, o = t["customer"], t["orders"]
    o_f = o.filter(~(o["o_comment"].contains("special")
                     & o["o_comment"].contains("requests")))
    return (c.join(o_f, on=(c["c_custkey"] == o_f["o_custkey"]),
                   how="left")
            .groupBy("c_custkey")
            .agg(F.count("o_orderkey").alias("c_count"))
            .groupBy("c_count")
            .agg(F.count("*").alias("custdist"))
            .orderBy(F.col("custdist").desc(), F.col("c_count").desc()))


def q15(t) -> "object":
    """Top supplier (agg view + global max via cross join;
    reference: Q15Like)."""
    li, s = t["lineitem"], t["supplier"]
    revenue = (li.filter((li["l_shipdate"] >= date_lit("1996-01-01"))
                         & (li["l_shipdate"] < date_lit("1996-04-01")))
               .withColumn("rev",
                           F.col("l_extendedprice")
                           * (F.lit(1.0) - F.col("l_discount")))
               .groupBy("l_suppkey")
               .agg(F.sum("rev").alias("total_revenue")))
    max_rev = revenue.agg(F.max("total_revenue").alias("max_revenue"))
    return (s.join(revenue, on=(s["s_suppkey"] == F.col("l_suppkey")),
                   how="inner")
            .crossJoin(max_rev)
            .filter(F.col("total_revenue") == F.col("max_revenue"))
            .select("s_suppkey", "s_name", "total_revenue")
            .orderBy("s_suppkey"))


def q16(t) -> "object":
    """Parts/supplier relationship (anti join + count-distinct rewritten as
    two-level group-by; reference: Q16Like uses countDistinct)."""
    ps, p, s = t["partsupp"], t["part"], t["supplier"]
    excl = s.filter(s["s_comment"].contains("Customer")
                    & s["s_comment"].contains("Complaints")) \
        .select(F.col("s_suppkey").alias("bad_supp"))
    return (ps.join(p, on=(ps["ps_partkey"] == p["p_partkey"]),
                    how="inner")
            .filter((F.col("p_brand") != F.lit("Brand#45"))
                    & ~F.col("p_type").startswith("MEDIUM POLISHED")
                    & F.col("p_size").isin(3, 9, 14, 19, 23, 36, 45, 49))
            .join(excl, on=(F.col("ps_suppkey") == F.col("bad_supp")),
                  how="left_anti")
            .groupBy("p_brand", "p_type", "p_size", "ps_suppkey")
            .agg(F.count("*").alias("_dup"))
            .groupBy("p_brand", "p_type", "p_size")
            .agg(F.count("*").alias("supplier_cnt"))
            .orderBy(F.col("supplier_cnt").desc(), F.col("p_brand"),
                     F.col("p_type"), F.col("p_size")))


def q17(t) -> "object":
    """Small-quantity-order revenue (correlated avg-subquery -> per-part agg
    + join-back; reference: Q17Like)."""
    li, p = t["lineitem"], t["part"]
    fil = p.filter((p["p_brand"] == F.lit("Brand#23"))
                   & (p["p_container"] == F.lit("MED BOX")))
    j = li.join(fil, on=(li["l_partkey"] == fil["p_partkey"]), how="inner")
    avg_qty = (j.groupBy("l_partkey")
               .agg((F.avg("l_quantity") * F.lit(0.2)).alias("avg_fifth"))
               .select(F.col("l_partkey").alias("ak"), F.col("avg_fifth")))
    return (j.join(avg_qty, on=(F.col("l_partkey") == F.col("ak")),
                   how="inner")
            .filter(F.col("l_quantity") < F.col("avg_fifth"))
            .agg((F.sum("l_extendedprice") / F.lit(7.0))
                 .alias("avg_yearly")))


def q18(t) -> "object":
    """Large volume customer (having-subquery -> agg + semi join;
    reference: Q18Like)."""
    c, o, li = t["customer"], t["orders"], t["lineitem"]
    big = (li.groupBy("l_orderkey")
           .agg(F.sum("l_quantity").alias("big_qty"))
           .filter(F.col("big_qty") > F.lit(300.0))
           .select(F.col("l_orderkey").alias("bk")))
    return (c.join(o, on=(c["c_custkey"] == o["o_custkey"]), how="inner")
            .join(big, on=(F.col("o_orderkey") == F.col("bk")),
                  how="left_semi")
            .join(li, on=(F.col("o_orderkey") == li["l_orderkey"]),
                  how="inner")
            .groupBy("c_name", "c_custkey", "o_orderkey", "o_orderdate",
                     "o_totalprice")
            .agg(F.sum("l_quantity").alias("sum_qty"))
            .orderBy(F.col("o_totalprice").desc(), F.col("o_orderdate"))
            .limit(100))


def q20(t) -> "object":
    """Potential part promotion (nested subqueries -> semi joins + per-key
    agg threshold; reference: Q20Like)."""
    li, p, ps, s, n = (t["lineitem"], t["part"], t["partsupp"],
                       t["supplier"], t["nation"])
    forest = p.filter(p["p_name"].startswith("forest")) \
        .select(F.col("p_partkey").alias("fp"))
    half_qty = (li.filter((li["l_shipdate"] >= date_lit("1994-01-01"))
                          & (li["l_shipdate"] < date_lit("1995-01-01")))
                .groupBy("l_partkey", "l_suppkey")
                .agg((F.sum("l_quantity") * F.lit(0.5)).alias("half_qty"))
                .select(F.col("l_partkey").alias("hp"),
                        F.col("l_suppkey").alias("hs"),
                        F.col("half_qty")))
    eligible_ps = (ps.join(forest, on=(ps["ps_partkey"] == F.col("fp")),
                           how="left_semi")
                   .join(half_qty,
                         on=((F.col("ps_partkey") == F.col("hp"))
                             & (F.col("ps_suppkey") == F.col("hs"))),
                         how="inner")
                   .filter(F.col("ps_availqty") > F.col("half_qty"))
                   .select(F.col("ps_suppkey").alias("ok_supp")))
    return (s.join(eligible_ps, on=(s["s_suppkey"] == F.col("ok_supp")),
                   how="left_semi")
            .join(n.filter(n["n_name"] == F.lit("NATION_4")),
                  on=(F.col("s_nationkey") == n["n_nationkey"]),
                  how="inner")
            .select("s_name", "s_address")
            .orderBy("s_name"))


def q21(t) -> "object":
    """Suppliers who kept orders waiting (reference: Q21Like). The
    EXISTS / NOT EXISTS subqueries carry a supplier-inequality, which
    equi-joins cannot host (the reference likewise keeps conditioned
    semi/anti joins off the accelerator, GpuHashJoin.scala:28-42);
    decomposed with per-order min/max supplier aggregates:
    'another supplier shipped this order' <=> min|max supplier != mine,
    'no other supplier was late'          <=> all late lines are mine."""
    li, o, s, n = t["lineitem"], t["orders"], t["supplier"], t["nation"]
    l1 = li.filter(li["l_receiptdate"] > li["l_commitdate"])
    any_supp = (li.groupBy("l_orderkey")
                .agg(F.min("l_suppkey").alias("mn2"),
                     F.max("l_suppkey").alias("mx2"))
                .select(F.col("l_orderkey").alias("k2"),
                        F.col("mn2"), F.col("mx2")))
    late_supp = (l1.groupBy("l_orderkey")
                 .agg(F.min("l_suppkey").alias("mn3"),
                      F.max("l_suppkey").alias("mx3"))
                 .select(F.col("l_orderkey").alias("k3"),
                         F.col("mn3"), F.col("mx3")))
    return (l1.join(o.filter(o["o_orderstatus"] == F.lit("F")),
                    on=(l1["l_orderkey"] == o["o_orderkey"]), how="inner")
            .join(s, on=(F.col("l_suppkey") == s["s_suppkey"]), how="inner")
            .join(n.filter(n["n_name"] == F.lit("NATION_5")),
                  on=(F.col("s_nationkey") == n["n_nationkey"]),
                  how="inner")
            # another supplier also shipped lines of this order …
            .join(any_supp, on=(F.col("l_orderkey") == F.col("k2")),
                  how="inner")
            .filter((F.col("mn2") != F.col("l_suppkey"))
                    | (F.col("mx2") != F.col("l_suppkey")))
            # … but every LATE line of the order is mine
            .join(late_supp, on=(F.col("l_orderkey") == F.col("k3")),
                  how="inner")
            .filter((F.col("mn3") == F.col("l_suppkey"))
                    & (F.col("mx3") == F.col("l_suppkey")))
            .groupBy("s_name")
            .agg(F.count("*").alias("numwait"))
            .orderBy(F.col("numwait").desc(), F.col("s_name"))
            .limit(100))


def q22(t) -> "object":
    """Global sales opportunity (substring + scalar avg + anti join;
    reference: Q22Like)."""
    c, o = t["customer"], t["orders"]
    cust = (c.withColumn("cntrycode",
                         F.substring(F.col("c_phone"), 1, 2))
            .filter(F.col("cntrycode").isin(
                "13", "31", "23", "29", "30", "18", "17")))
    avg_bal = cust.filter(F.col("c_acctbal") > F.lit(0.0)) \
        .agg(F.avg("c_acctbal").alias("avg_bal"))
    return (cust.crossJoin(avg_bal)
            .filter(F.col("c_acctbal") > F.col("avg_bal"))
            .join(o, on=(F.col("c_custkey") == o["o_custkey"]),
                  how="left_anti")
            .groupBy("cntrycode")
            .agg(F.count("*").alias("numcust"),
                 F.sum("c_acctbal").alias("totacctbal"))
            .orderBy("cntrycode"))


QUERIES = {
    "q1": q1, "q2": q2, "q3": q3, "q4": q4, "q5": q5, "q6": q6,
    "q7": q7, "q8": q8, "q9": q9, "q10": q10, "q11": q11, "q12": q12,
    "q13": q13, "q14": q14, "q15": q15, "q16": q16, "q17": q17,
    "q18": q18, "q19": q19, "q20": q20, "q21": q21, "q22": q22,
}
