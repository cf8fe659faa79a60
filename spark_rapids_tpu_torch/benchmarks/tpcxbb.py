"""TPCx-BB-like schema, data generator and queries (port of
spark_rapids_tpu/benchmarks/tpcxbb.py: `ts_lit` :37, `gen_tables` :42-166
and all 30 queries, `q05_like` :172 to `q30_like` :846, with the
reference's text; `QUERIES` :863). BASELINE config 5: window functions
(lag, rank), DECIMAL(p, s) arithmetic and aggregation, TIMESTAMP <-> long
and date casts, hour(), UNION, locate and length.

`gen_tables` makes the same random draws in the same order as the
reference, so one seed gives the same rows in both packages. Only the way
the columns are built differs: a money column goes in as its unscaled
cents (`HostColumnVector.from_unscaled`), where the reference builds a
list of `decimal.Decimal` a row; a categorical column gathers its pool
(`HostColumnVector.from_pool`). The review text keeps the reference's
per-row loop `_mk_review` (its draws interleave), which at SF 10 is 600,000
rows. SF 1 ~= 2.9M sales rows, 6M clicks.
"""

from __future__ import annotations

from decimal import Decimal
from typing import Callable, Dict

import numpy as np

from spark_rapids_tpu_torch.columnar.batch import HostColumnVector
from spark_rapids_tpu_torch.columnar.dtypes import DataType, DecimalType
from spark_rapids_tpu_torch.ops.literals import Literal
from spark_rapids_tpu_torch.plan import functions as F
from spark_rapids_tpu_torch.plan.column import Column
from spark_rapids_tpu_torch.plan.window_api import Window

_EPOCH = np.datetime64("1970-01-01", "s")
_CATEGORIES = ["BOOKS", "CLOTHING", "ELECTRONICS", "HOME", "SPORTS", "TOYS"]
_DEC_9_2 = DecimalType(9, 2)
_DEC_7_2 = DecimalType(7, 2)


def _secs(s: str) -> int:
    return int((np.datetime64(s, "s") - _EPOCH).astype(int))


def ts_lit(s: str) -> Column:
    """A TIMESTAMP literal from 'YYYY-MM-DDTHH:MM:SS'."""
    return Column(Literal(_secs(s) * 1_000_000, DataType.TIMESTAMP))


def _cents(unscaled, dtype=_DEC_9_2) -> HostColumnVector:
    return HostColumnVector.from_unscaled(unscaled, dtype)


def gen_tables(session, sf: float = 0.001, num_partitions: int = 4,
               seed: int = 7) -> Dict[str, "object"]:
    """store_sales / item / web_clickstreams / web_sales / store_returns /
    inventory / product_reviews at scale factor `sf` (reference :42)."""
    rng = np.random.default_rng(seed)
    n_sales = max(64, int(2_880_000 * sf))
    n_clicks = max(128, int(6_000_000 * sf))
    n_item = max(16, int(18_000 * sf))
    n_store = max(4, int(100 * max(sf, 0.01)))
    n_cust = max(16, int(100_000 * sf))

    t_lo, t_hi = _secs("2003-01-01T00:00:00"), _secs("2003-12-31T23:59:59")
    sold_ts = rng.integers(t_lo, t_hi, n_sales).astype(np.int64) * 1_000_000

    net_paid_c = rng.integers(100, 1_000_00, n_sales)
    net_profit_c = rng.integers(-50_00, 500_00, n_sales)
    store_sales = session.createDataFrame({
        "ss_sold_ts": sold_ts,
        "ss_store_sk": rng.integers(0, n_store, n_sales).astype(np.int64),
        "ss_customer_sk": rng.integers(0, n_cust, n_sales).astype(np.int64),
        "ss_item_sk": rng.integers(0, n_item, n_sales).astype(np.int64),
        "ss_quantity": rng.integers(1, 12, n_sales).astype(np.int32),
        "ss_net_paid": _cents(net_paid_c),
        "ss_net_profit": _cents(net_profit_c),
    }, [("ss_sold_ts", DataType.TIMESTAMP), ("ss_store_sk", "long"),
        ("ss_customer_sk", "long"), ("ss_item_sk", "long"),
        ("ss_quantity", "int"), ("ss_net_paid", "decimal(9,2)"),
        ("ss_net_profit", "decimal(9,2)")],
        num_partitions=num_partitions)

    price_c = rng.integers(100, 500_00, n_item)
    item = session.createDataFrame({
        "i_item_sk": np.arange(n_item, dtype=np.int64),
        "i_category": HostColumnVector.from_pool(
            _CATEGORIES, rng.integers(0, len(_CATEGORIES), n_item)),
        "i_current_price": _cents(price_c, _DEC_7_2),
    }, [("i_item_sk", "long"), ("i_category", "string"),
        ("i_current_price", "decimal(7,2)")],
        num_partitions=max(1, num_partitions // 2))

    click_ts = rng.integers(t_lo, t_hi, n_clicks).astype(np.int64) * 1_000_000
    web_clickstreams = session.createDataFrame({
        "wcs_user_sk": rng.integers(0, n_cust, n_clicks).astype(np.int64),
        "wcs_click_ts": click_ts,
        "wcs_item_sk": rng.integers(0, n_item, n_clicks).astype(np.int64),
    }, [("wcs_user_sk", "long"), ("wcs_click_ts", DataType.TIMESTAMP),
        ("wcs_item_sk", "long")],
        num_partitions=num_partitions)

    n_web = max(64, int(1_440_000 * sf))
    web_ts = rng.integers(t_lo, t_hi, n_web).astype(np.int64) * 1_000_000
    ws_paid_c = rng.integers(100, 1_000_00, n_web)
    web_sales = session.createDataFrame({
        "ws_sold_ts": web_ts,
        "ws_item_sk": rng.integers(0, n_item, n_web).astype(np.int64),
        "ws_bill_customer_sk":
            rng.integers(0, n_cust, n_web).astype(np.int64),
        "ws_quantity": rng.integers(1, 12, n_web).astype(np.int32),
        "ws_net_paid": _cents(ws_paid_c),
    }, [("ws_sold_ts", DataType.TIMESTAMP), ("ws_item_sk", "long"),
        ("ws_bill_customer_sk", "long"), ("ws_quantity", "int"),
        ("ws_net_paid", "decimal(9,2)")],
        num_partitions=num_partitions)

    n_ret = max(32, int(288_000 * sf))
    ret_ts = rng.integers(t_lo, t_hi, n_ret).astype(np.int64) * 1_000_000
    ret_amt_c = rng.integers(100, 500_00, n_ret)
    store_returns = session.createDataFrame({
        "sr_item_sk": rng.integers(0, n_item, n_ret).astype(np.int64),
        "sr_customer_sk": rng.integers(0, n_cust, n_ret).astype(np.int64),
        "sr_return_ts": ret_ts,
        "sr_return_amt": _cents(ret_amt_c),
    }, [("sr_item_sk", "long"), ("sr_customer_sk", "long"),
        ("sr_return_ts", DataType.TIMESTAMP),
        ("sr_return_amt", "decimal(9,2)")],
        num_partitions=max(1, num_partitions // 2))

    n_inv = max(64, int(720_000 * sf))
    inv_ts = rng.integers(t_lo, t_hi, n_inv).astype(np.int64) * 1_000_000
    inventory = session.createDataFrame({
        "inv_item_sk": rng.integers(0, n_item, n_inv).astype(np.int64),
        "inv_warehouse_sk": rng.integers(0, 5, n_inv).astype(np.int64),
        "inv_ts": inv_ts,
        "inv_quantity_on_hand":
            rng.integers(0, 500, n_inv).astype(np.int32),
    }, [("inv_item_sk", "long"), ("inv_warehouse_sk", "long"),
        ("inv_ts", DataType.TIMESTAMP), ("inv_quantity_on_hand", "int")],
        num_partitions=max(1, num_partitions // 2))

    # review text: word soup with sentiment words, built by the
    # reference's loop, whose draws interleave (reference :133-150)
    n_rev = max(48, int(60_000 * sf))
    _POS = ["good", "great", "love", "excellent", "happy"]
    _NEG = ["bad", "terrible", "hate", "broken", "awful"]
    _FILL = ["the", "item", "works", "shipping", "box", "brandx", "price"]
    ratings = rng.integers(1, 6, n_rev)

    def _mk_review(i):
        words = [_FILL[j] for j in rng.integers(0, len(_FILL), 4)]
        pool = _POS if ratings[i] >= 4 else \
            _NEG if ratings[i] <= 2 else _POS + _NEG
        words.insert(int(rng.integers(0, 4)),
                     pool[int(rng.integers(0, len(pool)))])
        return " ".join(words)

    product_reviews = session.createDataFrame({
        "pr_review_sk": np.arange(n_rev, dtype=np.int64),
        "pr_item_sk": rng.integers(0, n_item, n_rev).astype(np.int64),
        "pr_user_sk": rng.integers(0, n_cust, n_rev).astype(np.int64),
        "pr_rating": ratings.astype(np.int32),
        "pr_content": np.array([_mk_review(i) for i in range(n_rev)],
                               dtype=object),
    }, [("pr_review_sk", "long"), ("pr_item_sk", "long"),
        ("pr_user_sk", "long"), ("pr_rating", "int"),
        ("pr_content", "string")],
        num_partitions=max(1, num_partitions // 2))

    return {"store_sales": store_sales, "item": item,
            "web_clickstreams": web_clickstreams, "web_sales": web_sales,
            "store_returns": store_returns, "inventory": inventory,
            "product_reviews": product_reviews}


# ---------------------------------------------------------------------------
# queries
# ---------------------------------------------------------------------------
def q05_like(t) -> "object":
    """Clickstream sessionization (TPCx-BB q5-ish): per user, order clicks by
    timestamp, lag() to find gaps > 1h starting new sessions, then count
    sessions and clicks per user. Window + timestamp->long casts."""
    wcs = t["web_clickstreams"]
    w = Window.partitionBy("wcs_user_sk").orderBy("wcs_click_ts")
    secs = F.col("wcs_click_ts").cast("long")
    prev = F.lag(F.col("wcs_click_ts"), 1).over(w).cast("long")
    return (wcs
            .withColumn("gap", secs - F.coalesce(prev, secs))
            .withColumn("new_session",
                        F.when(F.col("gap") > F.lit(3600), F.lit(1))
                        .otherwise(F.lit(0)))
            .groupBy("wcs_user_sk")
            .agg((F.sum("new_session") + F.lit(1)).alias("sessions"),
                 F.count("*").alias("clicks"))
            .filter(F.col("clicks") > F.lit(1))
            .orderBy(F.col("sessions").desc(), F.col("wcs_user_sk"))
            .limit(100))


def q16_like(t) -> "object":
    """Decimal revenue delta around an event date (TPCx-BB q16-ish):
    store_sales x item, per-store decimal revenue before/after a pivot
    date via conditional decimal sums, ranked by total revenue.
    Decimal agg + timestamp->date cast + window rank."""
    ss, it = t["store_sales"], t["item"]
    pivot = ts_lit("2003-07-01T00:00:00")
    joined = (ss.join(it, on=(ss["ss_item_sk"] == it["i_item_sk"]),
                      how="inner")
              .filter(F.col("i_category").isin("BOOKS", "ELECTRONICS",
                                               "HOME")))
    before = F.when(F.col("ss_sold_ts") < pivot,
                    F.col("ss_net_paid")).otherwise(
        Column(Literal(Decimal(0), DecimalType(9, 2))))
    after = F.when(F.col("ss_sold_ts") >= pivot,
                   F.col("ss_net_paid")).otherwise(
        Column(Literal(Decimal(0), DecimalType(9, 2))))
    per_store = (joined
                 .withColumn("rev_before", before)
                 .withColumn("rev_after", after)
                 .groupBy("ss_store_sk")
                 .agg(F.sum("rev_before").alias("before_rev"),
                      F.sum("rev_after").alias("after_rev"),
                      F.sum("ss_net_paid").alias("total_rev")))
    w = Window.orderBy(F.col("total_rev").desc(), F.col("ss_store_sk"))
    return (per_store
            .withColumn("rev_rank", F.rank().over(w))
            .withColumn("delta",
                        F.col("after_rev") - F.col("before_rev"))
            .filter(F.col("rev_rank") <= F.lit(20))
            .orderBy("rev_rank"))


def q09_like(t) -> "object":
    """Aggregate profitability by store and day (TPCx-BB q9-ish):
    timestamp->date cast as group key, avg over decimals, having-style
    filter on the decimal aggregate."""
    ss = t["store_sales"]
    return (ss.withColumn("sold_date",
                          F.col("ss_sold_ts").cast("date"))
            .groupBy("ss_store_sk", "sold_date")
            .agg(F.sum("ss_net_profit").alias("profit"),
                 F.avg("ss_net_paid").alias("avg_paid"),
                 F.count("*").alias("n"))
            .filter(F.col("profit") > Column(Literal(Decimal("100"),
                                                     DecimalType(9, 2))))
            .orderBy(F.col("profit").desc(), F.col("ss_store_sk"),
                     F.col("sold_date"))
            .limit(50))


def q01_like(t) -> "object":
    """Frequently-sold items per store (TPCx-BB q1-ish basket shape):
    per-(store, item) sales counts, kept above a support threshold, top by
    count — groupBy + having + sort + limit over the fact table."""
    ss = t["store_sales"]
    return (ss.groupBy("ss_store_sk", "ss_item_sk")
            .agg(F.count("*").alias("cnt"),
                 F.sum("ss_quantity").alias("qty"))
            .filter(F.col("cnt") >= F.lit(2))
            .orderBy(F.col("cnt").desc(), F.col("ss_store_sk"),
                     F.col("ss_item_sk"))
            .limit(100))


def q06_like(t) -> "object":
    """Customers whose web spending grew half-over-half (TPCx-BB q6-ish):
    conditional DECIMAL sums per customer around a pivot, ratio filter —
    decimal arithmetic + division + sort."""
    ws = t["web_sales"]
    pivot = ts_lit("2003-07-01T00:00:00")
    first_h = F.when(F.col("ws_sold_ts") < pivot,
                     F.col("ws_net_paid")).otherwise(
        Column(Literal(Decimal(0), DecimalType(9, 2))))
    second_h = F.when(F.col("ws_sold_ts") >= pivot,
                      F.col("ws_net_paid")).otherwise(
        Column(Literal(Decimal(0), DecimalType(9, 2))))
    return (ws.withColumn("h1", first_h)
            .withColumn("h2", second_h)
            .groupBy("ws_bill_customer_sk")
            .agg(F.sum("h1").alias("h1_paid"),
                 F.sum("h2").alias("h2_paid"))
            .filter((F.col("h1_paid") > Column(Literal(Decimal("1"),
                                                       DecimalType(9, 2))))
                    & (F.col("h2_paid") > F.col("h1_paid")))
            .withColumn("growth",
                        F.col("h2_paid").cast("double")
                        / F.col("h1_paid").cast("double"))
            .orderBy(F.col("growth").desc(),
                     F.col("ws_bill_customer_sk"))
            .limit(100))


def q07_like(t) -> "object":
    """Stores selling items priced above 1.2x their category average
    (TPCx-BB q7-ish): category-average subaggregate joined back, price
    predicate, per-store counts."""
    ss, it = t["store_sales"], t["item"]
    cat_avg = (it.groupBy("i_category")
               .agg(F.avg(F.col("i_current_price").cast("double"))
                    .alias("cat_avg"))
               .select(F.col("i_category").alias("ac"), F.col("cat_avg")))
    pricey = (it.join(cat_avg, on=(it["i_category"] == F.col("ac")),
                      how="inner")
              .filter(F.col("i_current_price").cast("double")
                      > F.lit(1.2) * F.col("cat_avg"))
              .select(F.col("i_item_sk").alias("pricey_sk")))
    return (ss.join(pricey, on=(ss["ss_item_sk"] == F.col("pricey_sk")),
                    how="left_semi")
            .groupBy("ss_store_sk")
            .agg(F.count("*").alias("n_pricey"))
            .filter(F.col("n_pricey") >= F.lit(2))
            .orderBy(F.col("n_pricey").desc(), F.col("ss_store_sk"))
            .limit(50))


def q12_like(t) -> "object":
    """Click-then-buy conversion within 30 days (TPCx-BB q12-ish):
    clickstream joined to sales on (user, item) with a timestamp-window
    condition — multi-key join + timestamp arithmetic."""
    wcs, ss = t["web_clickstreams"], t["store_sales"]
    day_s = 86_400  # cast(ts as long) is epoch SECONDS (Spark)
    return (wcs.join(
        ss,
        on=((wcs["wcs_user_sk"] == ss["ss_customer_sk"])
            & (wcs["wcs_item_sk"] == ss["ss_item_sk"])),
        how="inner")
        .filter((F.col("ss_sold_ts").cast("long")
                 > F.col("wcs_click_ts").cast("long"))
                & (F.col("ss_sold_ts").cast("long")
                   - F.col("wcs_click_ts").cast("long")
                   < F.lit(30 * day_s)))
        .groupBy("wcs_item_sk")
        .agg(F.count("*").alias("conversions"))
        .orderBy(F.col("conversions").desc(), F.col("wcs_item_sk"))
        .limit(100))


def q15_like(t) -> "object":
    """Per-store monthly profit trend (TPCx-BB q15-ish): timestamp ->
    date -> month grouping, window lag for month-over-month delta, count
    of declining months per store."""
    ss = t["store_sales"]
    w = Window.partitionBy("ss_store_sk").orderBy("month")
    monthly = (ss.withColumn("sold_date",
                             F.col("ss_sold_ts").cast("date"))
               .withColumn("month", F.month(F.col("sold_date")))
               .groupBy("ss_store_sk", "month")
               .agg(F.sum("ss_net_profit").alias("profit")))
    return (monthly
            .withColumn("prev_profit", F.lag(F.col("profit"), 1).over(w))
            .withColumn("declined",
                        F.when(F.col("profit") < F.col("prev_profit"),
                               F.lit(1)).otherwise(F.lit(0)))
            .groupBy("ss_store_sk")
            .agg(F.sum("declined").alias("down_months"),
                 F.count("*").alias("months"))
            .orderBy(F.col("down_months").desc(), F.col("ss_store_sk")))


def q02_like(t) -> "object":
    """Items co-viewed within the same hour by one user (TPCx-BB q2-ish
    session co-occurrence): clickstream self-join on user with a time-window
    condition, unordered item pairs, counted and ranked."""
    wcs = t["web_clickstreams"]
    hour_s = 3600  # cast(ts as long) is epoch SECONDS (Spark)
    a = wcs.select(F.col("wcs_user_sk").alias("u1"),
                   F.col("wcs_item_sk").alias("it1"),
                   F.col("wcs_click_ts").alias("ts1"))
    b = wcs.select(F.col("wcs_user_sk").alias("u2"),
                   F.col("wcs_item_sk").alias("it2"),
                   F.col("wcs_click_ts").alias("ts2"))
    return (a.join(b, on=(F.col("u1") == F.col("u2")), how="inner")
            .filter((F.col("it1") < F.col("it2"))
                    & (F.col("ts2").cast("long") - F.col("ts1").cast("long")
                       < F.lit(hour_s))
                    & (F.col("ts1").cast("long") - F.col("ts2").cast("long")
                       < F.lit(hour_s)))
            .groupBy("it1", "it2")
            .agg(F.count("*").alias("coviews"))
            .filter(F.col("coviews") >= F.lit(2))
            .orderBy(F.col("coviews").desc(), F.col("it1"), F.col("it2"))
            .limit(100))


def q03_like(t) -> "object":
    """Distinct users who viewed an item within 10 days BEFORE buying it
    (TPCx-BB q3-ish view-before-buy): join clicks to sales on (user, item)
    with a before-purchase window, then a two-level aggregate emulating
    COUNT(DISTINCT user) per item."""
    wcs, ss = t["web_clickstreams"], t["store_sales"]
    day_s = 86_400  # cast(ts as long) is epoch SECONDS (Spark)
    hits = (wcs.join(
        ss,
        on=((wcs["wcs_user_sk"] == ss["ss_customer_sk"])
            & (wcs["wcs_item_sk"] == ss["ss_item_sk"])),
        how="inner")
        .filter((F.col("ss_sold_ts").cast("long")
                 >= F.col("wcs_click_ts").cast("long"))
                & (F.col("ss_sold_ts").cast("long")
                   - F.col("wcs_click_ts").cast("long")
                   < F.lit(10 * day_s))))
    per_user = (hits.groupBy("wcs_item_sk", "wcs_user_sk")
                .agg(F.count("*").alias("views")))
    return (per_user.groupBy("wcs_item_sk")
            .agg(F.count("*").alias("buyers_who_viewed"),
                 F.sum("views").alias("total_views"))
            .orderBy(F.col("buyers_who_viewed").desc(),
                     F.col("wcs_item_sk"))
            .limit(100))


def q08_like(t) -> "object":
    """Revenue from customers who never clicked vs those who did (TPCx-BB
    q8-ish reviews-vs-not split): left-semi and left-anti joins of sales
    against the clickstream user set, decimal revenue per branch."""
    ss, wcs = t["store_sales"], t["web_clickstreams"]
    clickers = wcs.select(F.col("wcs_user_sk").alias("cu"))
    clicked = (ss.join(clickers, on=(ss["ss_customer_sk"] == F.col("cu")),
                       how="left_semi")
               .agg(F.sum("ss_net_paid").alias("rev"),
                    F.count("*").alias("n"))
               .withColumn("cohort", F.lit("clicked")))
    silent = (ss.join(clickers, on=(ss["ss_customer_sk"] == F.col("cu")),
                      how="left_anti")
              .agg(F.sum("ss_net_paid").alias("rev"),
                   F.count("*").alias("n"))
              .withColumn("cohort", F.lit("silent")))
    return clicked.union(silent).orderBy("cohort")


def q11_like(t) -> "object":
    """Category price stats vs sales volume (TPCx-BB q11-ish correlation
    shape): join sales to item, per-category decimal revenue, quantity, and
    double avg-price aggregates side by side."""
    ss, it = t["store_sales"], t["item"]
    return (ss.join(it, on=(ss["ss_item_sk"] == it["i_item_sk"]),
                    how="inner")
            .groupBy("i_category")
            .agg(F.sum("ss_net_paid").alias("rev"),
                 F.sum("ss_quantity").alias("qty"),
                 F.avg(F.col("i_current_price").cast("double"))
                  .alias("avg_price"),
                 F.count("*").alias("n"))
            .withColumn("rev_per_unit",
                        F.col("rev").cast("double")
                        / F.col("qty").cast("double"))
            .orderBy("i_category"))


def q13_like(t) -> "object":
    """Web-to-store spend ratio per customer (TPCx-BB q13-ish channel
    shift): two per-customer aggregates joined, double division, top
    ratios."""
    ss, ws = t["store_sales"], t["web_sales"]
    store = (ss.groupBy("ss_customer_sk")
             .agg(F.sum("ss_net_paid").alias("store_paid")))
    web = (ws.groupBy("ws_bill_customer_sk")
           .agg(F.sum("ws_net_paid").alias("web_paid")))
    return (store.join(
        web, on=(store["ss_customer_sk"] == web["ws_bill_customer_sk"]),
        how="inner")
        .withColumn("ratio", F.col("web_paid").cast("double")
                    / F.col("store_paid").cast("double"))
        .filter(F.col("store_paid") > Column(Literal(Decimal("1"),
                                                     DecimalType(9, 2))))
        .orderBy(F.col("ratio").desc(), F.col("ss_customer_sk"))
        .limit(100))


def q14_like(t) -> "object":
    """Morning vs evening click traffic per category (TPCx-BB q14-ish
    'tween hours' ratio): hour() extraction, conditional counts, join to
    item for the category rollup."""
    wcs, it = t["web_clickstreams"], t["item"]
    hr = F.hour(F.col("wcs_click_ts"))
    return (wcs.join(it, on=(wcs["wcs_item_sk"] == it["i_item_sk"]),
                     how="inner")
            .withColumn("morning", F.when((hr >= F.lit(7))
                                          & (hr < F.lit(12)),
                                          F.lit(1)).otherwise(F.lit(0)))
            .withColumn("evening", F.when((hr >= F.lit(17))
                                          & (hr < F.lit(22)),
                                          F.lit(1)).otherwise(F.lit(0)))
            .groupBy("i_category")
            .agg(F.sum("morning").alias("am_clicks"),
                 F.sum("evening").alias("pm_clicks"),
                 F.count("*").alias("clicks"))
            .withColumn("am_pm_ratio",
                        F.col("am_clicks").cast("double")
                        / (F.col("pm_clicks").cast("double") + F.lit(1.0)))
            .orderBy("i_category"))


def q17_like(t) -> "object":
    """Promo-window share of revenue per category (TPCx-BB q17-ish):
    conditional decimal sum inside December vs the whole year, double
    ratio per category."""
    ss, it = t["store_sales"], t["item"]
    dec_lo = ts_lit("2003-12-01T00:00:00")
    promo = F.when(F.col("ss_sold_ts") >= dec_lo,
                   F.col("ss_net_paid")).otherwise(
        Column(Literal(Decimal(0), DecimalType(9, 2))))
    return (ss.join(it, on=(ss["ss_item_sk"] == it["i_item_sk"]),
                    how="inner")
            .withColumn("promo_paid", promo)
            .groupBy("i_category")
            .agg(F.sum("promo_paid").alias("promo_rev"),
                 F.sum("ss_net_paid").alias("total_rev"))
            .withColumn("promo_share",
                        F.col("promo_rev").cast("double")
                        / F.col("total_rev").cast("double"))
            .orderBy(F.col("promo_share").desc(), F.col("i_category")))


def q21_like(t) -> "object":
    """Items returned then re-purchased by the same customer within 90 days
    (TPCx-BB q21-ish returns behavior): returns joined back to sales on
    (customer, item) with a post-return window, counts and returned
    amounts per item."""
    sr, ss = t["store_returns"], t["store_sales"]
    day_s = 86_400  # cast(ts as long) is epoch SECONDS (Spark)
    return (sr.join(
        ss,
        on=((sr["sr_customer_sk"] == ss["ss_customer_sk"])
            & (sr["sr_item_sk"] == ss["ss_item_sk"])),
        how="inner")
        .filter((F.col("ss_sold_ts").cast("long")
                 > F.col("sr_return_ts").cast("long"))
                & (F.col("ss_sold_ts").cast("long")
                   - F.col("sr_return_ts").cast("long")
                   < F.lit(90 * day_s)))
        .groupBy("sr_item_sk")
        .agg(F.count("*").alias("rebuys"),
             F.sum("sr_return_amt").alias("returned_amt"))
        .orderBy(F.col("rebuys").desc(), F.col("sr_item_sk"))
        .limit(100))


def q29_like(t) -> "object":
    """Item-pair purchase affinity (TPCx-BB q29-ish basket pairs): sales
    self-join on customer over high-quantity purchases, unordered item
    pairs counted and ranked. The quantity filter bounds the quadratic
    blow-up the same way the reference thins with category filters."""
    ss = t["store_sales"]
    big = ss.filter(F.col("ss_quantity") >= F.lit(10))
    a = big.select(F.col("ss_customer_sk").alias("c1"),
                   F.col("ss_item_sk").alias("pit1"))
    b = big.select(F.col("ss_customer_sk").alias("c2"),
                   F.col("ss_item_sk").alias("pit2"))
    return (a.join(b, on=(F.col("c1") == F.col("c2")), how="inner")
            .filter(F.col("pit1") < F.col("pit2"))
            .groupBy("pit1", "pit2")
            .agg(F.count("*").alias("together"))
            .filter(F.col("together") >= F.lit(2))
            .orderBy(F.col("together").desc(), F.col("pit1"),
                     F.col("pit2"))
            .limit(100))


def q04_like(t) -> "object":
    """Abandoned shopping days (TPCx-BB q4-ish): per (user, day) click
    activity anti-joined against any same-day purchase by that user —
    date-keyed anti-join over two fact tables, top abandoned browsers."""
    wcs, ss = t["web_clickstreams"], t["store_sales"]
    browse = (wcs.withColumn("cday", F.col("wcs_click_ts").cast("date"))
              .groupBy("wcs_user_sk", "cday")
              .agg(F.count("*").alias("clicks")))
    bought = (ss.withColumn("bday", F.col("ss_sold_ts").cast("date"))
              .select(F.col("ss_customer_sk").alias("bc"), F.col("bday")))
    return (browse.join(
        bought,
        on=((browse["wcs_user_sk"] == F.col("bc"))
            & (browse["cday"] == F.col("bday"))),
        how="left_anti")
        .groupBy("wcs_user_sk")
        .agg(F.count("*").alias("abandoned_days"),
             F.sum("clicks").alias("wasted_clicks"))
        .filter(F.col("wasted_clicks") >= F.lit(2))
        .orderBy(F.col("wasted_clicks").desc(), F.col("wcs_user_sk"))
        .limit(100))


def q10_like(t) -> "object":
    """Review sentiment by category (TPCx-BB q10-ish, the NLP UDF replaced
    by contains() word predicates): positive/negative word hits as
    conditional counts per category, with the double ratio."""
    pr, it = t["product_reviews"], t["item"]
    pos = (F.col("pr_content").contains("good")
           | F.col("pr_content").contains("great")
           | F.col("pr_content").contains("love"))
    neg = (F.col("pr_content").contains("bad")
           | F.col("pr_content").contains("terrible")
           | F.col("pr_content").contains("hate"))
    return (pr.join(it, on=(pr["pr_item_sk"] == it["i_item_sk"]),
                    how="inner")
            .withColumn("is_pos", F.when(pos, F.lit(1)).otherwise(F.lit(0)))
            .withColumn("is_neg", F.when(neg, F.lit(1)).otherwise(F.lit(0)))
            .groupBy("i_category")
            .agg(F.sum("is_pos").alias("pos_reviews"),
                 F.sum("is_neg").alias("neg_reviews"),
                 F.avg(F.col("pr_rating").cast("double")).alias("avg_rating"),
                 F.count("*").alias("reviews"))
            .withColumn("sentiment",
                        (F.col("pos_reviews") - F.col("neg_reviews"))
                        .cast("double")
                        / F.col("reviews").cast("double"))
            .orderBy("i_category"))


def q18_like(t) -> "object":
    """Stores with a declining monthly profit trend (TPCx-BB q18-ish, the
    linear-regression slope as explicit sum-product aggregates): join each
    store's monthly profits to its averages, slope numerator
    sum((m - m̄)(p - p̄)) < 0 keeps decliners."""
    ss = t["store_sales"]
    monthly = (ss.withColumn("m",
                             F.month(F.col("ss_sold_ts").cast("date")))
               .groupBy("ss_store_sk", "m")
               .agg(F.sum(F.col("ss_net_profit").cast("double"))
                    .alias("profit")))
    means = (monthly.groupBy("ss_store_sk")
             .agg(F.avg(F.col("m").cast("double")).alias("m_bar"),
                  F.avg("profit").alias("p_bar"))
             .select(F.col("ss_store_sk").alias("msk"),
                     F.col("m_bar"), F.col("p_bar")))
    return (monthly.join(means,
                         on=(monthly["ss_store_sk"] == F.col("msk")),
                         how="inner")
            .withColumn("dev",
                        (F.col("m").cast("double") - F.col("m_bar"))
                        * (F.col("profit") - F.col("p_bar")))
            .groupBy("ss_store_sk")
            .agg(F.sum("dev").alias("slope_num"),
                 F.count("*").alias("months"))
            .filter((F.col("slope_num") < F.lit(0.0))
                    & (F.col("months") >= F.lit(3)))
            .orderBy(F.col("slope_num"), F.col("ss_store_sk")))


def q19_like(t) -> "object":
    """Returned items with angry reviews (TPCx-BB q19-ish): per-item
    decimal return totals joined to low-rating review counts — two
    aggregates joined, ordered by returned amount."""
    sr, pr = t["store_returns"], t["product_reviews"]
    rets = (sr.groupBy("sr_item_sk")
            .agg(F.sum("sr_return_amt").alias("returned_amt"),
                 F.count("*").alias("returns")))
    angry = (pr.filter(F.col("pr_rating") <= F.lit(2))
             .groupBy("pr_item_sk")
             .agg(F.count("*").alias("angry_reviews"))
             .select(F.col("pr_item_sk").alias("ak"),
                     F.col("angry_reviews")))
    return (rets.join(angry, on=(rets["sr_item_sk"] == F.col("ak")),
                      how="inner")
            .orderBy(F.col("returned_amt").desc(), F.col("sr_item_sk"))
            .limit(100))


def q20_like(t) -> "object":
    """Customer return-behavior features (TPCx-BB q20-ish k-means feature
    prep): per-customer order/return counts and amounts, return ratios as
    doubles — the clustering input vector without the clustering."""
    ss, sr = t["store_sales"], t["store_returns"]
    orders = (ss.groupBy("ss_customer_sk")
              .agg(F.count("*").alias("orders"),
                   F.sum("ss_net_paid").alias("paid")))
    rets = (sr.groupBy("sr_customer_sk")
            .agg(F.count("*").alias("returns"),
                 F.sum("sr_return_amt").alias("returned"))
            .select(F.col("sr_customer_sk").alias("rk"),
                    F.col("returns"), F.col("returned")))
    return (orders.join(rets, on=(orders["ss_customer_sk"] == F.col("rk")),
                        how="inner")
            .withColumn("return_rate",
                        F.col("returns").cast("double")
                        / F.col("orders").cast("double"))
            .withColumn("amt_rate",
                        F.col("returned").cast("double")
                        / F.col("paid").cast("double"))
            .filter(F.col("return_rate") > F.lit(0.0))
            .orderBy(F.col("return_rate").desc(),
                     F.col("ss_customer_sk"))
            .limit(100))


def q22_like(t) -> "object":
    """Inventory before/after a pivot date (TPCx-BB q22 shape): per
    (item, warehouse) quantity sums around the pivot, keep ratios in
    [2/3, 3/2] — the classic conditional-sum + ratio-band HAVING."""
    inv = t["inventory"]
    pivot = ts_lit("2003-07-01T00:00:00")
    before = F.when(F.col("inv_ts") < pivot,
                    F.col("inv_quantity_on_hand")).otherwise(F.lit(0))
    after = F.when(F.col("inv_ts") >= pivot,
                   F.col("inv_quantity_on_hand")).otherwise(F.lit(0))
    return (inv.withColumn("qb", before).withColumn("qa", after)
            .groupBy("inv_item_sk", "inv_warehouse_sk")
            .agg(F.sum("qb").alias("inv_before"),
                 F.sum("qa").alias("inv_after"))
            .filter((F.col("inv_before") > F.lit(0))
                    & (F.col("inv_after").cast("double")
                       >= F.lit(2.0 / 3.0)
                       * F.col("inv_before").cast("double"))
                    & (F.col("inv_after").cast("double")
                       <= F.lit(1.5)
                       * F.col("inv_before").cast("double")))
            .orderBy("inv_item_sk", "inv_warehouse_sk")
            .limit(100))


def q23_like(t) -> "object":
    """Inventory volatility (TPCx-BB q23 shape): monthly quantity per
    (item, warehouse), then the coefficient of variation via sum/sum-of-
    squares aggregates. cov > 0.1 is tested as its square
    var/mean^2 > 0.01 — same predicate, no Sqrt (which is incompat-gated
    off by default like the reference's floating-point ops)."""
    inv = t["inventory"]
    monthly = (inv.withColumn("m",
                              F.month(F.col("inv_ts").cast("date")))
               .groupBy("inv_item_sk", "inv_warehouse_sk", "m")
               .agg(F.sum(F.col("inv_quantity_on_hand").cast("double"))
                    .alias("q")))
    return (monthly
            .withColumn("q2", F.col("q") * F.col("q"))
            .groupBy("inv_item_sk", "inv_warehouse_sk")
            .agg(F.avg("q").alias("mean_q"),
                 F.avg("q2").alias("mean_q2"),
                 F.count("*").alias("months"))
            .filter((F.col("months") >= F.lit(3))
                    & (F.col("mean_q") > F.lit(0.0)))
            .withColumn("cov2",
                        (F.col("mean_q2")
                         - F.col("mean_q") * F.col("mean_q"))
                        / (F.col("mean_q") * F.col("mean_q")))
            .filter(F.col("cov2") > F.lit(0.01))
            .orderBy(F.col("cov2").desc(), F.col("inv_item_sk"),
                     F.col("inv_warehouse_sk"))
            .limit(100))


def q24_like(t) -> "object":
    """Channel mix for premium items (TPCx-BB q24-ish price-sensitivity
    shape): items priced >= 1.2x category average, web vs store quantity
    sums joined and ratioed."""
    ss, ws, it = t["store_sales"], t["web_sales"], t["item"]
    cat_avg = (it.groupBy("i_category")
               .agg(F.avg(F.col("i_current_price").cast("double"))
                    .alias("cavg"))
               .select(F.col("i_category").alias("cc"), F.col("cavg")))
    prem = (it.join(cat_avg, on=(it["i_category"] == F.col("cc")),
                    how="inner")
            .filter(F.col("i_current_price").cast("double")
                    >= F.lit(1.2) * F.col("cavg"))
            .select(F.col("i_item_sk").alias("pk")))
    s_qty = (ss.join(prem, on=(ss["ss_item_sk"] == F.col("pk")),
                     how="left_semi")
             .groupBy("ss_item_sk")
             .agg(F.sum("ss_quantity").alias("store_qty")))
    w_qty = (ws.groupBy("ws_item_sk")
             .agg(F.sum("ws_quantity").alias("web_qty"))
             .select(F.col("ws_item_sk").alias("wk"), F.col("web_qty")))
    return (s_qty.join(w_qty, on=(s_qty["ss_item_sk"] == F.col("wk")),
                       how="inner")
            .withColumn("web_share",
                        F.col("web_qty").cast("double")
                        / (F.col("web_qty") + F.col("store_qty"))
                        .cast("double"))
            .orderBy(F.col("web_share").desc(), F.col("ss_item_sk"))
            .limit(100))


def q25_like(t) -> "object":
    """RFM customer segmentation features (TPCx-BB q25-ish): recency
    (max ts as long), frequency, monetary from store + web sales unioned
    into one per-customer feature row."""
    ss, ws = t["store_sales"], t["web_sales"]
    s = ss.select(F.col("ss_customer_sk").alias("c"),
                  F.col("ss_sold_ts").cast("long").alias("ts"),
                  F.col("ss_net_paid").alias("paid"))
    w = ws.select(F.col("ws_bill_customer_sk").alias("c"),
                  F.col("ws_sold_ts").cast("long").alias("ts"),
                  F.col("ws_net_paid").alias("paid"))
    return (s.union(w)
            .groupBy("c")
            .agg(F.max("ts").alias("recency"),
                 F.count("*").alias("frequency"),
                 F.sum("paid").alias("monetary"))
            .filter(F.col("frequency") >= F.lit(2))
            .orderBy(F.col("monetary").desc(), F.col("c"))
            .limit(100))


def q26_like(t) -> "object":
    """Per-customer category spend vector (TPCx-BB q26-ish cluster-input
    shape): join to item, one conditional decimal sum per category column
    (the manual pivot), active customers only."""
    ss, it = t["store_sales"], t["item"]
    joined = ss.join(it, on=(ss["ss_item_sk"] == it["i_item_sk"]),
                     how="inner")
    zero = Column(Literal(Decimal(0), DecimalType(9, 2)))
    agg_cols = []
    for cat in ("BOOKS", "ELECTRONICS", "CLOTHING"):
        joined = joined.withColumn(
            f"paid_{cat.lower()}",
            F.when(F.col("i_category") == F.lit(cat),
                   F.col("ss_net_paid")).otherwise(zero))
        agg_cols.append(F.sum(f"paid_{cat.lower()}")
                        .alias(f"{cat.lower()}_spend"))
    return (joined.groupBy("ss_customer_sk")
            .agg(*agg_cols, F.count("*").alias("n"))
            .filter(F.col("n") >= F.lit(3))
            .orderBy(F.col("n").desc(), F.col("ss_customer_sk"))
            .limit(100))


def q27_like(t) -> "object":
    """Competitor mentions in reviews (TPCx-BB q27-ish, NER replaced by
    locate/substring): reviews naming 'brandx', the mention position and a
    context snippet extracted, counted per category."""
    pr, it = t["product_reviews"], t["item"]
    return (pr.filter(F.col("pr_content").contains("brandx"))
            .withColumn("pos", F.locate("brandx", F.col("pr_content")))
            .withColumn("snippet",
                        F.substring(F.col("pr_content"), 1, 20))
            .join(it, on=(F.col("pr_item_sk") == it["i_item_sk"]),
                  how="inner")
            .groupBy("i_category")
            .agg(F.count("*").alias("mentions"),
                 F.avg(F.col("pos").cast("double")).alias("avg_pos"))
            .orderBy("i_category"))


def q28_like(t) -> "object":
    """Sentiment-classifier data prep (TPCx-BB q28-ish): deterministic
    train/test split by review id modulo, label from the rating threshold,
    per-(split, label) counts and mean text length."""
    pr = t["product_reviews"]
    return (pr.withColumn("split",
                          F.when(F.col("pr_review_sk") % F.lit(10)
                                 < F.lit(9),
                                 F.lit("train")).otherwise(F.lit("test")))
            .withColumn("label",
                        F.when(F.col("pr_rating") >= F.lit(4),
                               F.lit(1)).otherwise(F.lit(0)))
            .withColumn("len", F.length(F.col("pr_content")))
            .groupBy("split", "label")
            .agg(F.count("*").alias("n"),
                 F.avg(F.col("len").cast("double")).alias("avg_len"))
            .orderBy("split", "label"))


def q30_like(t) -> "object":
    """Items reviewed together (TPCx-BB q30-ish viewed-together affinity):
    reviews self-joined on user, unordered distinct item pairs counted and
    ranked."""
    pr = t["product_reviews"]
    a = pr.select(F.col("pr_user_sk").alias("ua"),
                  F.col("pr_item_sk").alias("ia"))
    b = pr.select(F.col("pr_user_sk").alias("ub"),
                  F.col("pr_item_sk").alias("ib"))
    return (a.join(b, on=(F.col("ua") == F.col("ub")), how="inner")
            .filter(F.col("ia") < F.col("ib"))
            .groupBy("ia", "ib")
            .agg(F.count("*").alias("together"))
            .orderBy(F.col("together").desc(), F.col("ia"), F.col("ib"))
            .limit(100))


def window_frames(t) -> "object":
    """Frame aggregates over the clickstream (not a reference query; the
    window frames its q05 does not reach, with the reference's API): per
    user by click time, the running sum of item keys (the default RANGE
    UNBOUNDED PRECEDING .. CURRENT ROW), their max over the last four
    clicks (ROWS 3 PRECEDING .. CURRENT ROW) and the clicks of the last
    hour (RANGE over the TIMESTAMP key, 3,600,000,000 micros)."""
    wcs = t["web_clickstreams"]
    w = Window.partitionBy("wcs_user_sk").orderBy("wcs_click_ts")
    return (wcs
            .withColumn("running_items", F.sum("wcs_item_sk").over(w))
            .withColumn("max_last4",
                        F.max("wcs_item_sk").over(w.rowsBetween(-3, 0)))
            .withColumn("clicks_last_hour", F.count("wcs_item_sk").over(
                w.rangeBetween(-3_600_000_000, 0))))


QUERIES: Dict[str, Callable] = {
    "q01_like": q01_like, "q02_like": q02_like, "q03_like": q03_like,
    "q04_like": q04_like, "q05_like": q05_like, "q06_like": q06_like,
    "q07_like": q07_like, "q08_like": q08_like, "q09_like": q09_like,
    "q10_like": q10_like, "q11_like": q11_like, "q12_like": q12_like,
    "q13_like": q13_like, "q14_like": q14_like, "q15_like": q15_like,
    "q16_like": q16_like, "q17_like": q17_like, "q18_like": q18_like,
    "q19_like": q19_like, "q20_like": q20_like, "q21_like": q21_like,
    "q22_like": q22_like, "q23_like": q23_like, "q24_like": q24_like,
    "q25_like": q25_like, "q26_like": q26_like, "q27_like": q27_like,
    "q28_like": q28_like, "q29_like": q29_like, "q30_like": q30_like,
}
