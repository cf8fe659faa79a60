"""Mortgage-ETL-like schema, data generator and queries (port of
spark_rapids_tpu/benchmarks/mortgage.py: `gen_tables` :28 and the 6
queries with the reference's text, `q_delinquency` :70 to `q_percentiles`
:230; `QUERIES` :248). The reference's third benchmark family
(MortgageSpark.scala): acquisition and performance tables joined into
delinquency features, with date arithmetic, conditional aggregation, an
explode over 12 month offsets, first() and exact percentiles.

`gen_tables` makes the same random draws in the same order as the
reference, so one seed gives the same rows in both packages. Only the
seller column is built differently: it gathers a 20-string pool by the
same `rng.integers(0, 20, n)` draw (`HostColumnVector.from_pool`) where
the reference formats a string a row. SF 1 = 400,000 loans and 9.6M
performance rows.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np

from spark_rapids_tpu_torch.columnar.batch import HostColumnVector
from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.plan import functions as F

_EPOCH = np.datetime64("1970-01-01", "D")
_SELLERS = [f"SELLER_{i}" for i in range(20)]


def _days(s: str) -> int:
    return int((np.datetime64(s, "D") - _EPOCH).astype(int))


def gen_tables(session, sf: float = 0.001, num_partitions: int = 4,
               seed: int = 13) -> Dict[str, "object"]:
    """acquisition (1 row per loan) + performance (24 rows per loan)."""
    rng = np.random.default_rng(seed)
    n_loans = max(32, int(400_000 * sf))
    n_perf = n_loans * 24

    lo, hi = _days("2000-01-01"), _days("2008-12-31")
    acquisition = session.createDataFrame({
        "loan_id": np.arange(n_loans, dtype=np.int64),
        "orig_date": rng.integers(lo, hi, n_loans).astype(np.int32),
        "orig_upb": rng.integers(50_000, 800_000, n_loans).astype(np.int64),
        "credit_score": rng.integers(300, 850, n_loans).astype(np.int32),
        "dti": (rng.random(n_loans) * 60).astype(np.float32),
        "zip": rng.integers(10_000, 99_999, n_loans).astype(np.int32),
        "orig_rate": (rng.random(n_loans) * 5 + 2).astype(np.float32),
        "seller": HostColumnVector.from_pool(
            _SELLERS, rng.integers(0, 20, n_loans)),
    }, [("loan_id", "long"), ("orig_date", DataType.DATE),
        ("orig_upb", "long"), ("credit_score", "int"), ("dti", "float"),
        ("zip", "int"), ("orig_rate", "float"),
        ("seller", "string")], num_partitions=max(1, num_partitions // 2))

    loan = rng.integers(0, n_loans, n_perf).astype(np.int64)
    month = rng.integers(0, 72, n_perf).astype(np.int32)
    performance = session.createDataFrame({
        "loan_id": loan,
        "report_date": (lo + month * 30).astype(np.int32),
        "current_upb": rng.integers(0, 800_000, n_perf).astype(np.int64),
        # 0 = current, 1-5 = months delinquent, 6 = default-ish
        "delinq_status": np.minimum(
            rng.geometric(0.6, n_perf) - 1, 6).astype(np.int32),
        "interest_rate": (rng.random(n_perf) * 5 + 2).astype(np.float32),
    }, [("loan_id", "long"), ("report_date", DataType.DATE),
        ("current_upb", "long"), ("delinq_status", "int"),
        ("interest_rate", "float")],
        num_partitions=num_partitions)

    return {"acquisition": acquisition, "performance": performance}


def q_delinquency(t) -> "object":
    """Per-loan delinquency features (the reference's core ETL join):
    conditional aggregates over status, joined back to acquisition."""
    perf, acq = t["performance"], t["acquisition"]
    ever30 = F.when(F.col("delinq_status") >= F.lit(1),
                    F.lit(1)).otherwise(F.lit(0))
    ever90 = F.when(F.col("delinq_status") >= F.lit(3),
                    F.lit(1)).otherwise(F.lit(0))
    feats = (perf
             .withColumn("e30", ever30)
             .withColumn("e90", ever90)
             .groupBy("loan_id")
             .agg(F.max("delinq_status").alias("worst"),
                  F.sum("e30").alias("months_30"),
                  F.sum("e90").alias("months_90"),
                  F.min("current_upb").alias("min_upb"),
                  F.count("*").alias("n_reports")))
    return (acq.join(feats, on="loan_id", how="inner")
            .filter(F.col("months_90") > F.lit(0))
            .withColumn("upb_paid_frac",
                        F.lit(1.0) - F.col("min_upb")
                        / F.col("orig_upb"))
            .orderBy(F.col("worst").desc(), F.col("loan_id"))
            .limit(100))


def q_seller_quarter(t) -> "object":
    """Quarter-level seller rollup (date bucketing + join + agg + sort)."""
    perf, acq = t["performance"], t["acquisition"]
    joined = perf.join(acq, on="loan_id", how="inner")
    quarter = (F.year(F.col("report_date")) * F.lit(10)
               + F.quarter(F.col("report_date")))
    bad = F.when(F.col("delinq_status") >= F.lit(3),
                 F.col("current_upb")).otherwise(F.lit(0))
    return (joined
            .withColumn("yq", quarter)
            .withColumn("bad_upb", bad)
            .groupBy("seller", "yq")
            .agg(F.sum("current_upb").alias("upb"),
                 F.sum("bad_upb").alias("bad_upb"),
                 F.avg("credit_score").alias("avg_score"),
                 F.count("*").alias("n"))
            .filter(F.col("n") > F.lit(5))
            .orderBy(F.col("bad_upb").desc(), F.col("seller"), F.col("yq"))
            .limit(50))


def q_delinquency_12(t) -> "object":
    """The reference's headline 12-month delinquency ETL
    (CreatePerformanceDelinquency.apply, MortgageSpark.scala:229-299):
    per-loan ever-30/90/180 flags carried through an explode over the 12
    month offsets with floor-div month bucketing ('josh_mody_n'), max/min
    rollup per (loan, bucket, flags, offset), year/month restored via
    floor + pmod with the 0->12 fixup, and a 3-key (loan, year, month)
    left join back onto the raw performance rows. Exercises explode,
    integer bucketing arithmetic, pmod, and a 3-key left join."""
    perf = t["performance"]
    base = (perf.withColumn("ty", F.year(F.col("report_date")))
            .withColumn("tm", F.month(F.col("report_date")))
            .withColumn("ym", F.col("ty") * F.lit(12) + F.col("tm")))
    flags = (base
             .groupBy("loan_id")
             .agg(F.max("delinq_status").alias("worst")))
    flags = flags.select(
        F.col("loan_id").alias("f_loan"),
        (F.col("worst") >= F.lit(1)).alias("ever_30"),
        (F.col("worst") >= F.lit(3)).alias("ever_90"),
        (F.col("worst") >= F.lit(6)).alias("ever_180"))
    joined = base.join(flags, on=(F.col("loan_id") == F.col("f_loan")),
                       how="left_outer")
    months = 12
    offs = F.explode(F.array(*[F.lit(i) for i in range(months)]))
    exploded = (joined.select(
        F.col("loan_id"), F.col("ym"), F.col("delinq_status"),
        F.col("current_upb"), F.col("ever_30"), F.col("ever_90"),
        F.col("ever_180"), offs.alias("month_y"))
                .withColumn(
                    "bucket",
                    F.floor((F.col("ym").cast("double")
                             - F.lit(24000.0)
                             - F.col("month_y").cast("double"))
                            / F.lit(float(months))).cast("long")))
    # the flags ride the rollup keys exactly like the reference's
    # groupBy(quarter, loan, josh_mody_n, ever_30, ..., month_y)
    rolled = (exploded
              .groupBy("loan_id", "bucket", "month_y",
                       "ever_30", "ever_90", "ever_180")
              .agg(F.max("delinq_status").alias("delinq_12"),
                   F.min("current_upb").alias("upb_12")))
    # year/month restoration: floor + pmod with the reference's 0 -> 12
    # month fixup (MortgageSpark.scala:293-296)
    ym2 = F.lit(24000) + F.col("bucket") * F.lit(months) + F.col("month_y")
    m2t = F.pmod(ym2, F.lit(12))
    restored = (rolled
                .withColumn("m2", F.when(m2t == F.lit(0), F.lit(12))
                            .otherwise(m2t))
                .withColumn("y2",
                            F.floor((ym2.cast("double") - F.lit(1.0))
                                    / F.lit(12.0)).cast("long"))
                .withColumn("d12_score",
                            (F.col("delinq_12") > F.lit(3)).cast("int")
                            + (F.col("upb_12") == F.lit(0)).cast("int")
                            + F.col("ever_90").cast("int"))
                .select(F.col("loan_id").alias("r_loan"), F.col("y2"),
                        F.col("m2"), F.col("d12_score"), F.col("upb_12"),
                        F.col("ever_180")))
    return (base.join(
        restored,
        on=((F.col("loan_id") == F.col("r_loan"))
            & (F.col("ty").cast("long") == F.col("y2"))
            & (F.col("tm").cast("long") == F.col("m2"))),
        how="left_outer")
        .groupBy("loan_id")
        .agg(F.max("d12_score").alias("max_d12"),
             F.min("upb_12").alias("min_upb"),
             F.max(F.col("ever_180").cast("int")).alias("ever_180"),
             F.count("*").alias("n"))
        .orderBy(F.col("max_d12").desc_nulls_first(), F.col("loan_id"))
        .limit(100))


def q_simple_agg(t) -> "object":
    """SimpleAggregates (MortgageSpark.scala:349-365): per-(month, loan)
    max interest rate, joined to acquisition, per-(zip, month) min of
    those maxes."""
    perf, acq = t["performance"], t["acquisition"]
    max_rate = (perf.withColumn("monthval",
                                F.month(F.col("report_date")))
                .groupBy("monthval", "loan_id")
                .agg(F.max("interest_rate").alias("max_monthly_rate")))
    joined = max_rate.join(
        acq.select(F.col("loan_id").alias("a_loan"), F.col("zip")),
        on=(F.col("loan_id") == F.col("a_loan")), how="inner")
    return (joined.groupBy("zip", "monthval")
            .agg(F.min("max_monthly_rate").alias("min_max_monthly_rate"))
            .orderBy("zip", "monthval")
            .limit(200))


def q_agg_join(t) -> "object":
    """AggregatesWithJoin (MortgageSpark.scala:392-421): two per-loan
    aggregates left-joined with a coalesce default (the reference
    anonymizes loan_id through hex(hash()) first — grouping directly on
    the key keeps the same plan shape)."""
    perf, acq = t["performance"], t["acquisition"]
    a = (perf.groupBy("loan_id")
         .agg(F.min("interest_rate").alias("min_int_rate")))
    b = (acq.groupBy("loan_id")
         .agg(F.first("orig_rate").alias("first_int_rate"),
              F.max("dti").alias("max_dti_raw"))
         .select(F.col("loan_id").alias("b_loan"),
                 F.col("first_int_rate"),
                 F.coalesce(F.col("max_dti_raw"),
                            F.lit(0.0).cast("float")).alias("max_dti")))
    return (a.join(b, on=(F.col("loan_id") == F.col("b_loan")),
                   how="left_outer")
            .orderBy("loan_id")
            .limit(200))


def q_percentiles(t) -> "object":
    """AggregatesWithPercentiles (MortgageSpark.scala:367-390): per-loan
    interest-rate min/max/avg plus the exact 50/75/90/99th percentiles —
    the holistic percentile aggregate over the performance fact table."""
    perf = t["performance"]
    return (perf.groupBy("loan_id")
            .agg(F.min("interest_rate").alias("rate_min"),
                 F.max("interest_rate").alias("rate_max"),
                 F.avg(F.col("interest_rate").cast("double"))
                 .alias("rate_avg"),
                 F.percentile(F.col("interest_rate"), 0.50).alias("p50"),
                 F.percentile(F.col("interest_rate"), 0.75).alias("p75"),
                 F.percentile(F.col("interest_rate"), 0.90).alias("p90"),
                 F.percentile(F.col("interest_rate"), 0.99).alias("p99"))
            .orderBy(F.col("rate_avg").desc(), F.col("loan_id"))
            .limit(100))


QUERIES: Dict[str, Callable] = {
    "q_delinquency": q_delinquency,
    "q_seller_quarter": q_seller_quarter,
    "q_delinquency_12": q_delinquency_12,
    "q_simple_agg": q_simple_agg,
    "q_agg_join": q_agg_join,
    "q_percentiles": q_percentiles,
}
