#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py                 # all phases, flagship at 2^26 rows
    python3 chip_smoke.py --q02-probe 2,4,6   # q02's peak memory by SF
    python3 chip_smoke.py --mortgage-probe 2,5,10   # q_delinquency_12's

Builds the port's hand-written CUDA kernels from spark_rapids_tpu_torch/csrc
(one nvcc per source, in parallel) and then:

1. flagship at full width: bench.py's query (filter a % 3 != 0 and b < 0.9,
   c = a * 2 + 1, group by k: sum(c), count(*), max(a)) over bench.py's data
   (seed 42, k in [0, 1024), a int64, b float32, 2 partitions, cached) at
   2^26 rows, through new_session() / createDataFrame().cache() / collect(),
   with the plan asserted all on the device; all 1024 rows are checked
   against a direct numpy group-by; the warm query time is the median of 3;
2. high-cardinality keys (2^24 rows, k in [0, 2^22)): the partial output
   exceeds the exchange's zero-copy piece cap, so the routed tier and the
   route half of K4 run; checked the same way;
3. every kernel against its plain PyTorch version on the card, at the
   flagship's shapes and at edge cases (8 rows, all pads, one group, NaN /
   -0.0 / inf keys, nulls, int64 sums that wrap): integer outputs must match
   bit for bit, float sums within a relative 1e-5 (f32) / 1e-12 (f64)
   because the summation order differs; each is timed with CUDA events
   beside its plain version, a one-call PyTorch yardstick where one exists,
   and its bound (bytes read once plus written once over 3.35 TB/s). The
   string kernels K5-K7 run on edge cases (empty, NULL, non-ASCII, 64 bytes
   and longer, prefix pairs) and at 2^25 rows shaped like l_shipmode and
   l_shipinstruct (K7 gathers the latter through a random permutation);
   their words, offsets and bytes must match bit for bit;
4. TPC-H q1 and q6 at SF 10 (60,000,000 lineitem rows; the port's
   gen_tables, 4 partitions, every table cached as bench.py does), one cold
   and 3 warm runs each, plans asserted all on the device, results checked
   against a direct numpy computation over the generated columns (counts
   exact, DOUBLE sums and averages within a relative 1e-9, q1's 6 rows in
   ORDER BY order); then one q1 run with the exchange's zero-copy piece cap
   at 0, which routes every map batch (K4's route half, K7's string
   pieces), checked the same way;
5. TPC-H q3 and q5 over the same cached SF 10 tables (15,000,000 orders,
   1,500,000 customers, 100,000 suppliers; 8 shuffle partitions), one cold
   and 3 warm runs each, then q5 once more with every join shuffled
   (autoBroadcastJoinThreshold 0, runtime broadcast off). Plans are asserted
   all on the device, each query must run at least one shuffled and one
   broadcast hash join (planned, or demoted by the runtime probe; the log
   says which), and the rows must equal a direct numpy computation (the
   generator's primary keys are arange, so each join is an index lookup
   and each aggregate a weighted bincount): q3's 10 rows in ORDER BY order
   with exact keys, q5's ASIA nations in order, revenue within a relative
   1e-9. Phase 3 also holds K8 (string_compare) at 2^25 rows shaped like
   c_mktsegment, against the literal 'BUILDING' and against a permutation
   of itself, and K9-K11 (join_build, join_probe, join_expand) at the
   shape of q5's s_suppkey = l_suppkey (2^23 build rows, keys in [0, 2^21),
   2^22 stream rows, half of their keys present) and a skewed stream (1%
   of its rows on one key), against their plain versions. Phase 3 holds
   K12 (string_search) and K13 (substring_plan) too: on corner cases (an
   empty needle, a needle longer than the row, a match on the last byte,
   self-overlapping partial matches, bytes >= 0x80 and NUL, a match that
   would cross rows, NULL rows; SUBSTRING with negative, zero and per-row
   positions and lengths, a wrapping length, rows that start with a UTF-8
   continuation byte), K12 at 15M rows shaped like o_comment in every mode
   and K13 at 2^24 rows shaped like c_phone, bit for bit;
6. TPC-H q2, q4 and q7-q22 over the same cached SF 10 tables (2,000,000
   parts, 8,000,000 partsupp rows), one cold and 3 warm runs each, every
   plan asserted all on the device, the log stating how each join ran
   (broadcast, shuffled, demoted by the runtime probe, nested loop);
   q12, q13, q14 and q22 are checked against a direct numpy computation
   over the generated columns (keys and counts exact, DOUBLE within a
   relative 1e-9, rows in ORDER BY order), the others' warm rows against
   their cold run; then all 22 queries at SMALL_SF on the card against the
   port's own numpy CPU engine (rapids.tpu.sql.enabled=false: the same
   planner, none of the device kernels), rows in order;
7. the TPCx-BB-like suite (BASELINE config 5) after the TPC-H tables are
   released: the port's tpcxbb.gen_tables at SF 10 (28.8M store_sales,
   60M web_clickstreams, 14.4M web_sales, 7.2M inventory, 2.88M
   store_returns, 600,000 product_reviews, 180,000 items), 4 partitions,
   every table cached, 8 shuffle partitions, as bench.py --tpcxbb lays it
   out; all 30 queries one cold and SUITE_WARM_REPS warm runs each (q02
   at Q02_SF on its own tables: its self-join's pairs, PERF.md), every
   plan asserted
   all on the device, with the geomean of the warm medians; q16 (decimal
   sums in int64 cents, exact, and before + after == total), q05
   (sessions and clicks per user from a sort by user and click time), q01
   and q28 against numpy, the others' warm rows against their cold run;
   the window-frames path (running sum, ROWS max, hour RANGE count over
   the clicks; its running sum against numpy); then all 30 and the frames
   path at SF 0.01 on the card against the port's CPU engine. Phase 3
   holds K14-K16 (window_segments, window_rank_offset, window_frame_agg)
   and K17 (string_chars) too: bit for bit on edge cases (empty batch, one
   row, one partition, all peers, NULL keys, NULLS FIRST / LAST,
   descending, NaN / -0.0 keys, an int64 lag default beyond int32, RANGE
   frames with NULL keys, empty frames; invalid UTF-8, empty rows, start
   < 1, the empty needle) and timed at q05's window batch (7.5M rows) and
   over pr_content;
8. the mortgage ETL suite after phase 7's tables are released: the port's
   mortgage.gen_tables at SF 10 (4,000,000 acquisition rows, 96,000,000
   performance rows), 4 partitions, every table cached, 8 shuffle
   partitions, as bench.py --mortgage lays it out; all 6 queries one cold
   and SUITE_WARM_REPS warm runs each (q_delinquency_12 at
   MORTGAGE_D12_SF on its own tables: its explode, PERF.md), every plan
   asserted all on the device,
   the log stating how each join ran; q_percentiles (min, max, avg and the
   exact 50/75/90/99th percentiles by np.lexsort), q_delinquency
   (conditional sums and counts by np.bincount, minimum by
   np.minimum.reduceat, the acquisition columns gathered by loan id) and
   q_agg_join (first() is the loan's own
   orig_rate) against numpy, the others' warm rows against their cold run;
   the per-loan group-by at SF 1 with 5000 shuffle partitions (past K4's
   shared-memory histogram) against its run at 8; then all 6 at SF 0.01 on
   the card against the port's CPU engine. Phase 3 holds K18
   (explode_rows), K19 (segment_percentile), K3's first / last and K4 at
   4095, 4096, 5000 and 65,536 partitions to their plain versions bit for
   bit (0 rows, 1 row, k = 1 and 12, NULL elements, int64 / BOOL / STRING
   children; NaN, -0.0, +-inf, all-NULL and one-row groups, p = 0 and 1, a
   group past 2^24 rows; NULL first rows with and without ignore_nulls),
   and times K18 at q_delinquency_12's exploded batch, K19 at
   q_percentiles' batch and K3's first at q_agg_join's;
9. Parquet (run after phase 6, while its SF 10 tables are cached): the
   six tables q1-q5 read (60M lineitem rows, 15M orders, ...) written
   with df.write.parquet (SNAPPY, encoded on the card by K22) to a
   temporary directory, with the seconds and bytes of each; orders read
   back and compared with the generated table on the card, column for
   column, bit for bit; q1, q6, q3 and q5 over read.parquet, one cold and
   PARQUET_WARM_REPS warm runs each (every scan decodes on the card: K20,
   K21, K7's span
   entry), every leaf a TpuFileScanExec, rows against phases 4-5's numpy
   results, with each query's scan host seconds (file reads, Snappy, page
   and run walks) beside its wall time; the reference's decode shape
   (bench.py:_worker_decode: 4 << 20 rows, int64 a, b and int32 c from
   seed 7, v1 dictionary pages, SNAPPY, row groups of 2^19, written by
   write_dict_fixture without pyarrow) summed against numpy, with its GB/s
   (20 bytes a row over the run's seconds); the files are removed at the
   end. Phase 3 holds K20-K22 and K7's span entry bit for bit (bit widths
   1-32; RLE, bit-packed and mixed streams; 0 rows, all-NULL pages,
   required columns, several pages, every element width; empty, non-ASCII
   and 64+ byte strings) and times them at one lineitem partition (15M
   rows).
10. encoded (dictionary) execution (after the Parquet phase, on the same
   cached tables): bench.py --encoded's lineitem-like table (seed 42) and
   its rank companion's sorted table (seed 7) at 60M rows, 8 row groups,
   every column a SNAPPY v1 dictionary chunk in first-seen order, and
   phase 4's SF 10 lineitem and orders with dictionary chunks for their
   STRING and DATE columns (PLAIN keys and DOUBLEs), all written by
   write_parquet_fixture without pyarrow; q_agg, q_join (shuffled),
   q_sort, q_minmax, TPC-H q1 and q12, each one cold and ENCODED_WARM_REPS
   warm runs with
   rapids.tpu.sql.encoded.enabled true and then false, against numpy,
   with the encoded columns the scan emitted, the device decodes (K23
   launches) before the sink, K24 and K4-code launches and peak device
   bytes; every 'on' run must show encoded columns and every 'off' run
   none, and q_agg must decode no STRING column before the sink. Phase 3
   holds K21's codes mode, K23 (fixed, string), K24 (fill 0 and -1) and
   K4's code mode bit for bit (an all-NULL chunk, a required column,
   ndv = 1, codes at and past the table's end, empty batches, a
   dictionary with "" and multi-byte UTF-8, an absent value, one stream
   dictionary against two build dictionaries; K4's code mode also
   against K4 over the decoded values) and times them at one 7.5M-row
   row group. The decode shape also runs with encoding off.
11. Parquet v2 (the layouts Spark's and Arrow's writers produce), in two
   places. In the Parquet phase, while phase 4's tables are cached: the
   seven lineitem columns q1 and q6 read written one file a partition
   (the four DOUBLEs BYTE_STREAM_SPLIT, l_shipdate DELTA_BINARY_PACKED,
   the flags dictionaries; v2 pages, SNAPPY, row groups of 2^20, pages of
   2^17, by write_parquet_fixture without pyarrow), then q1 and q6 over
   them against phase 4's numpy rows. In phase 7, before its tables are
   released: the tables each query reads written in the TPCx-BB layout
   (keys that pass a 1 MiB dictionary fall back to DELTA pages, small-
   domain keys stay dictionaries, timestamps, INT32 counts and dense ids
   DELTA, decimals 4-byte FIXED_LEN_BYTE_ARRAY, i_category
   DELTA_BYTE_ARRAY, pr_content DELTA_LENGTH_BYTE_ARRAY; q02 on its SF 5
   tables, left out if they take more than Q02_V2_MAX_WRITE_S to write),
   then all 30 queries over read.parquet of them, one cold and
   V2_WARM_REPS warm runs each, every leaf a TpuFileScanExec, rows equal
   to the same query's over the cached tables, with each query's scan
   host seconds and the geomean of their times (best_s) beside phase 7's;
   then a read with the kernel library failing to load must raise. Phase
   3 holds K25 (delta_expand), K26 (delta_byte_array) and K21's BSS and
   FLBA modes bit for bit to their plain versions (empty and one-value
   streams, width 0 and widths 57-64, 1-16 byte FLBA with negatives,
   NULLs, a DBA page whose prefixes chain across 3000 strings, whole v2
   chunks with a mixed dictionary -> DELTA chunk) and times each at one
   2^20-row row group (K25 on wcs_click_ts, K21 FLBA on ss_net_paid, K21
   BSS on l_extendedprice, K26 on an l_comment-like column).
12. ORC (after the Parquet phase, on phase 4's cached SF 10 tables): the
   six tables q1-q5 read written with df.write.orc (SNAPPY, Spark's ORC
   codec; a stripe a partition, encoded on the card by K29 and K22's ORC
   mode), orders also ZLIB and read back bit for bit; a 4M-row host
   table with NULLs in BOOLEAN, SHORT, INT, LONG, DATE, FLOAT, DOUBLE and
   STRING columns written (the writer uploads it; K29 and K22's ORC mode
   must launch) and read back bit for bit (K28 over PRESENT and BOOLEAN
   streams); q1, q6, q3 and q5 over read.orc, one cold and ORC_WARM_REPS
   warm runs each (K27, K21, K7's span entry), every leaf a
   TpuFileScanExec, rows against phases 4-5's numpy, with each query's
   scan host seconds; then lineitem's q1 / q6 columns written one file a
   partition by write_orc_fixture in the layout of Hive's and Spark's
   (Java) writer, without pyarrow: ZLIB blocks of 256 KiB, stripes of
   2^21 rows, the flags DICTIONARY_V2, l_shipdate RLEv2 with every
   sub-encoding (the log gives each kind's runs), and q1 and q6 over it
   against numpy, then a read with the kernel library failing to load
   must raise. Phase 3 holds K27 (rlev2_expand), K28 (present_expand),
   K29 (orc_encode_direct) and K22's ORC mode (orc_pack_present) bit for
   bit to their plain versions (every sub-encoding, widths 1-64, runs of
   1, 3, 10 and 512, patches at run ends, byte-RLE across byte and run
   boundaries, empty and all-NULL stripes, BOOLEAN, TIMESTAMP, FLOAT,
   SHORT and INT stripe columns) and times them at one 15M-row lineitem
   stripe (K27 also over a Hive stripe's flag indices).
13. the memory layer, after the encoded phase: (a) phase 4's six q1-q5
   host tables at SF 10 cached in a session whose device budget
   (hbm.sizeOverride, allocFraction 1) is half their device bytes and
   whose host tier is a quarter of them, q5 and q1 once each against
   numpy, with the bytes spilled device -> host and host -> disk, the
   rematerialisations and the peak device bytes beside the budget (both
   tiers must be used); (b) lineitem's q1 columns cached, then a ballast
   tensor
   from torch.cuda.mem_get_info leaves free half of what q1 needed above
   it: q1's CUDA OutOfMemoryError becomes TpuRetryOOM, spills the device
   store and runs again, against numpy with retries >= 1; (c) q1 at SF 1
   with fusion off under injected OOMs at the filter and project sites
   (the reference's keys and decisions): a seed whose first filter batch
   bisects (splitRetries >= 1, K31 and K32 in the halves), then rate 1 at
   the filter site, where every filter batch runs on the CPU engine
   (cpuFallbackEvents >= 1) and the breaker opens; rows against numpy each
   time. Phase 3 holds K31
   (compact_fixed) and K32 (gather_fixed) bit for bit to their plain
   versions (every fixed dtype, 0 rows, none / all kept, out-of-range,
   negative and masked indices, a four-piece concat) and times them at a
   15M-row lineitem partition under q1's filter, at q5's join emit and at
   a split half.
14. CSV, after phase 13 releases the SF 10 tables: the port's
   tpch.gen_tables at CSV_SF 3 with 12 partitions (18M lineitem rows, 4.5M
   orders, 450,000 customers, 30,000 suppliers), each of q1-q5's six
   tables written with df.write.option("sep", "|").option("header",
   False).csv (the seconds and bytes of each; SF 10's lineitem would be
   ~6.6 GB of text), read back with read.schema(...).option("sep",
   "|").csv, and q1, q6, q3 and q5 over them, one cold and CSV_WARM_REPS
   warm runs each, every plan on the device and every leaf a
   TpuFileScanExec, rows against numpy over the generated columns (the
   phase 4 / 5 checkers) and against the same query over the SF 3 tables
   cached on the card, bit for bit where both plans join alike (the
   session reads a file as one batch, as a cached partition is), else
   within TPCH_REL; each query's scan host seconds (file reads
   and field plans) beside its wall time, and csvHostSplits, which must be
   0. Phase 3 holds K33 (csv_parse_int), K34 (csv_parse_float), K35
   (csv_parse_datetime) and K36 (csv_null_sentinels) bit for bit to their
   plain versions (empty and NULL-spelled fields, quoted and bare; -0,
   int64 max, max + 1 and min; 19 and 20 digits; INT8 / INT16 / INT32 out
   of range; 15 and 16 significant and 22 and 23 fractional digits; 1e5;
   2000-02-29, 1900-02-29 and 2023-02-30; every zone form, 6 and 7
   fraction digits; CRLF; a field at raw's last byte); phase 14 times
   them, again bit for bit with their plain versions, over the first
   lineitem file it wrote (1.5M rows of 14 columns, planned as the scan
   plans it; K35's timestamp mode over the same text with a time and zone
   after each l_shipdate).
15. string cleaning, right after phase 6 over its cached SF 10 tables
   with rapids.tpu.sql.incompatibleOps.enabled (the case maps are ASCII
   on the card): STRING_PROGRAMS (strings_lineitem: a concat_ws key,
   regexp_replace and replace of l_shipinstruct, trim of a nested concat,
   grouped; strings_orders: substring_index codes of o_orderpriority under
   lower / initcap, upper(lower(o_orderstatus)), grouped; strings_customer:
   substring_index, replace, concat, lower, regexp_replace and ltrim of
   c_phone and c_name, every row; strings_part: substring_index, initcap,
   regexp_replace and rtrim(concat) of part's strings, grouped), one cold
   and STRING_WARM_REPS warm runs each, every plan on the device, rows
   (sorted by their keys) against numpy and Python string operations over
   the generated columns; the same programs at SMALL_SF against the port's
   CPU engine (in phase 6's small-SF pass). Phase 3 holds K37
   (string_case_map), K38 (string_span_plan), K39 (string_replace) and K40
   (string_concat) bit for bit to their plain versions (NULL, empty and
   all-space rows, non-ASCII and NUL bytes, delimiters at a row's first and
   last byte, counts -3..3 and an empty delimiter, replacements that grow,
   shrink, keep the length or are empty, 1-5 concat members with literal
   and NULL-literal members, a 1 MiB row, a 0-row batch, a buffer exactly
   full); phase 15 times them over one 15M-row lineitem partition.
16. casts to and from STRING, right after phase 15 over the same cached
   SF 10 tables with rapids.tpu.sql.castFloatToString.enabled,
   castStringToFloat.enabled and castStringToTimestamp.enabled:
   CAST_PROGRAMS (casts_lineitem: l_shipdate and l_extendedprice as text,
   concat(day, ' 08:30:00.250') parsed as a timestamp and formatted back,
   every price parsed back, grouped by the texts; casts_orders: o_orderdate
   with 'T23:59:59.999999-02:00' parsed (the next day in UTC) and
   formatted as a date, SUBSTRING of o_orderkey's text, every price parsed
   back, grouped; casts_customer: c_custkey, c_acctbal as DOUBLE and FLOAT,
   a boolean, the phone digits as a DOUBLE (scientific notation) and the
   balance parsed back through leading whitespace, every row), one cold
   and CAST_WARM_REPS warm runs each, every plan on the device; lineitem
   and orders (sorted) against numpy and Python's datetime, customer's
   every row against Python (str, repr placed Java's way by java_text,
   numpy's float32 str); the same programs at SMALL_SF against the port's
   CPU engine (in phase 6's small-SF pass). Phase 3 holds K41
   (format_fixed), K42 (format_float), K43 (parse_float) and K44
   (parse_timestamp) bit for bit to their plain versions (cast_edge_cases:
   the int8-int64, date and timestamp ends, every power of two, 1M random
   f64 and f32 bit patterns, the grammars' edge rows, NULL, all-NULL and
   0-row batches); phase 16 times them over one 15M-row lineitem
   partition, K42's bound the larger of its bytes and its FP64 operations.
17. the DataFrame surface, right after phase 16 over the same cached
   SF 10 tables: SURFACE_PROGRAMS (surface_rollup: lineitem.rollup(
   l_returnflag, l_linestatus) with sum, avg, min(l_shipmode),
   max(l_shipinstruct), max(l_discount > 0.05), min(l_tax < 0.02) and
   count, 180M rows through Expand; surface_cube: orders.cube(
   o_orderstatus, o_orderpriority) with count, sum and max(o_comment)
   (the generator's orders have no o_clerk); surface_repartition:
   lineitem renamed and narrowed, repartition(64) round robin, grouped;
   surface_distinct: orders.repartition(32, o_custkey), distinct pairs,
   count(); surface_dedup_pair: lineitem.dropDuplicates over (l_orderkey,
   l_partkey), count() (the generator has no l_linenumber);
   surface_dedup_key: dropDuplicates over l_orderkey, 15M rows as host
   columns, each equal to an input row; surface_range: session.range of
   2^27 ids in 8 partitions, repartition(16), grouped by id % 1000 with
   GroupedData.sum), one cold and SURFACE_WARM_REPS warm runs of each
   collected program, every operator on the card but RangeExec; rows
   against numpy (bincounts over pool indices, np.unique of the pairs, a
   row hash for the dedupe, the range's sums in closed form); the
   round-robin partitions' rows against the arithmetic, the hash ones
   against the CPU engine's hash; coalesce(2), sortWithinPartitions with
   show(5) (five rows on stdout) and the GroupedData sum / min / max / avg
   shortcuts against numpy; the same programs at SMALL_SF against the
   port's CPU engine. Phase 3 holds K45 (round_robin_route), K46
   (assemble_routed_fixed), K47 (segment_arg_extreme_string) and K3's
   BOOL / any lanes bit for bit to their plain versions (surface_edge_
   cases); phase 17 times them at its shapes.
18. Expressions (slice 16, after phase 17 over the same tables, with
   incompatibleOps on): EXPR_PROGRAMS (math, date arithmetic and parts,
   bitwise ops and shifts, the NULL / NaN functions, abs / signum /
   negation / div / pmod), each grouped and checked against its
   reference (numpy's datetime64 calendar; values and groups as torch's
   own ops on the card, apart from K48); a scan-form stage with a
   LocalLimit and one with an Expand against their fusion-off rows;
   monotonically_increasing_id / spark_partition_id against their
   arithmetic, rand(42) against its own rerun and [0, 1); one K48 launch
   a partial-update batch of q1's and the flagship's Filter -> Project
   -> update chain, with the CUDA kernels a batch with fusion on and off
   (torch.profiler); the same programs at SMALL_SF against the CPU
   engine. Phase 3 holds K48 (stage_program) bit for bit to its plain
   interpreter over every op family and edge inputs, and records the
   ulp gap of each transcendental op (k48_ulp_gaps); phase 18 times K48
   at q1's and the flagship's update shapes.
19. Compressed execution (slice 17, right after phase 10, on its files and
   phase 4's cached tables): (a) phase 10's rank companion written again
   with l_shipmode and l_bucket as RLE index runs (write_rle_companion),
   bench.py's q_runs (groupBy(l_shipmode): count, sum(l_bucket)) with
   rapids.tpu.sql.runAware.enabled on and off, a cold and one warm run
   each, a row group a scan batch (RUNS_CONF): rows against numpy,
   runCollapsedRows against the rows the written runs collapse (0 off),
   the largest K48 launch no wider than a run batch (and a row group's
   with it off); phase 10's q_sort and q_minmax over the companion
   against numpy; (b) Window.partitionBy(l_returnflag).orderBy(l_shipmode)
   with rank, dense_rank, row_number and lag(l_quantity) over it, encoding
   on (rank space) and off, checked against numpy per flag (ranks in
   code-point order, row_number a permutation within each tie, lag the
   previous row's; off: the partition counts and the dense ranks'
   multiset), orderPreservingSorts one a window batch, K24 launched inside
   the rank remap (the companion's dictionaries list their entries in
   pool order, the flags' R, N, A) and no K5 / K6 string words with
   encoding on; (c) phase 10's q_join (shuffled; encoding on and off) and
   q_sort and TPC-H q5 over the cached tables, each unserialized and then
   with rapids.tpu.shuffle.serialize.enabled, a cold and one warm run
   each: rows against numpy, the serialized bytes of a run counted as
   bench.py counts them (the join's fewer encoded than decoded) and the
   host store's bytes; then q_sort with one shuffle.fetch loss injected
   (a seed whose rolls lose exactly one read), which runs its map
   partition again: fetchRetries 1 and equal rows.

Launch counts are reset just before each path's run and read just after
it (flagship, high_cardinality, tpch_q1, tpch_q6, tpch_q1_routed, tpch_q3,
tpch_q5, tpch_q5_shuffled, tpch_q2 ... tpch_q22 of phase 6, and
tpcxbb_q01_like ... tpcxbb_q30_like and tpcxbb_window_frames of phase 7,
mortgage_q_agg_join ... mortgage_q_simple_agg and
mortgage_many_partitions of phase 8, parquet_write, parquet_tpch_q1,
parquet_tpch_q6, parquet_tpch_q3, parquet_tpch_q5, parquet_decode_shape
and parquet_decode_shape_off of phase 9, encoded_q_agg ...
encoded_tpch_q12 and their _off runs of phase 10, parquet_v2_tpch_q1,
parquet_v2_tpch_q6 and parquet_v2_xbb_q01 ... parquet_v2_xbb_q30 of
phase 11, orc_write, orc_round_trip, orc_tpch_q1, orc_tpch_q6,
orc_tpch_q3, orc_tpch_q5, orc_hive_q1 and orc_hive_q6 of phase 12,
memory_spill_q5, memory_spill_q1, memory_oom_q1, memory_split and
memory_fallback of phase 13, csv_tpch_q1, csv_tpch_q6, csv_tpch_q3 and
csv_tpch_q5 of phase 14, strings_lineitem, strings_orders,
strings_customer and strings_part of phase 15, casts_lineitem,
casts_orders and casts_customer of phase 16, surface_rollup ...
surface_range of phase 17, expr_math ... expr_expand_stage of phase 18,
compressed_q_runs ... serialized_q_sort_fetch_loss of phase 19);
every kernel of a path must have launched in that path's own run. In the
kernels
line, "launches" is the count of the kernel's own path ("path") and
"launches_by_path" holds every run's counts.

Output: the card's name and power limit, then one JSON line with the
kernels, then the last line {"ok": true, "device": {...}}. Exits
non-zero, printing no result, without a CUDA device or without the
package beside this script.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
# the kernel-timing pass at the end: CUDA-event calls a kernel (10 until
# PR 14's cut) and calls a plain version or a library call (2 and 10)
KERNEL_ITERS = 5
PLAIN_ITERS = 1
FLAGSHIP_ROWS = 1 << 26
N_KEYS = 1024
HIGH_CARD_ROWS = 1 << 24
HIGH_CARD_KEYS = 1 << 22
K8_ROWS = 1 << 25  # like c_mktsegment
# q5's s_suppkey = l_suppkey: build rows, stream rows, build key range
JOIN_SHAPE = (1 << 23, 1 << 22, 1 << 21)

# name: (source, replaced JAX function, the path whose run gives "launches")
KERNELS = {
    "radix_sort_pairs": (
        "spark_rapids_tpu_torch/csrc/radix_sort.cu",
        "spark_rapids_tpu/exec/rowkeys.py:220", "flagship"),
    "group_ids": (
        "spark_rapids_tpu_torch/csrc/group_ids.cu",
        "spark_rapids_tpu/exec/rowkeys.py:309", "flagship"),
    "segment_reduce": (
        "spark_rapids_tpu_torch/csrc/segment_reduce.cu",
        "spark_rapids_tpu/exec/rowkeys.py:434", "flagship"),
    "hash_partition": (
        "spark_rapids_tpu_torch/csrc/hash_partition.cu",
        "spark_rapids_tpu/ops/hashing.py:228", "flagship"),
    "route_plan": (
        "spark_rapids_tpu_torch/csrc/hash_partition.cu",
        "spark_rapids_tpu/shuffle/exchange.py:1315", "high_cardinality"),
    "string_hash_words": (
        "spark_rapids_tpu_torch/csrc/string_hash.cu",
        "spark_rapids_tpu/ops/hashing.py:118", "tpch_q1"),
    "string_order_words": (
        "spark_rapids_tpu_torch/csrc/string_order.cu",
        "spark_rapids_tpu/exec/rowkeys.py:108", "tpch_q1"),
    "gather_strings": (
        "spark_rapids_tpu_torch/csrc/string_gather.cu",
        "spark_rapids_tpu/columnar/batch.py:1592", "tpch_q1"),
    "string_compare": (
        "spark_rapids_tpu_torch/csrc/string_compare.cu",
        "spark_rapids_tpu/columnar/strings.py:118", "tpch_q3"),
    "join_build": (
        "spark_rapids_tpu_torch/csrc/hash_join.cu",
        "spark_rapids_tpu/exec/join.py:150", "tpch_q5"),
    "join_probe": (
        "spark_rapids_tpu_torch/csrc/hash_join.cu",
        "spark_rapids_tpu/exec/join.py:172", "tpch_q5"),
    "join_expand": (
        "spark_rapids_tpu_torch/csrc/hash_join.cu",
        "spark_rapids_tpu/exec/join.py:554", "tpch_q5"),
    "string_search": (
        "spark_rapids_tpu_torch/csrc/string_search.cu",
        "spark_rapids_tpu/columnar/strings.py:377", "tpch_q13"),
    "substring_plan": (
        "spark_rapids_tpu_torch/csrc/substring.cu",
        "spark_rapids_tpu/columnar/strings.py:284", "tpch_q22"),
    "window_segments": (
        "spark_rapids_tpu_torch/csrc/window_segments.cu",
        "spark_rapids_tpu/exec/window.py:241", "tpcxbb_q05_like"),
    "window_rank_offset": (
        "spark_rapids_tpu_torch/csrc/window_rank_offset.cu",
        "spark_rapids_tpu/exec/window.py:413", "tpcxbb_q05_like"),
    "window_frame_agg": (
        "spark_rapids_tpu_torch/csrc/window_frame_agg.cu",
        "spark_rapids_tpu/exec/window.py:549", "tpcxbb_window_frames"),
    "string_chars": (
        "spark_rapids_tpu_torch/csrc/string_chars.cu",
        "spark_rapids_tpu/columnar/strings.py:542", "tpcxbb_q27_like"),
    "explode_rows": (
        "spark_rapids_tpu_torch/csrc/explode.cu",
        "spark_rapids_tpu/exec/expand.py:257", "mortgage_q_delinquency_12"),
    "segment_percentile": (
        "spark_rapids_tpu_torch/csrc/segment_percentile.cu",
        "spark_rapids_tpu/exec/rowkeys.py:480", "mortgage_q_percentiles"),
    "hybrid_expand": (
        "spark_rapids_tpu_torch/csrc/parquet_decode.cu",
        "spark_rapids_tpu/io/parquet_device.py:443", "parquet_decode_shape"),
    "page_decode_fixed": (
        "spark_rapids_tpu_torch/csrc/parquet_decode.cu",
        "spark_rapids_tpu/io/parquet_device.py:865", "parquet_tpch_q1"),
    "encode_plain_page": (
        "spark_rapids_tpu_torch/csrc/parquet_encode.cu",
        "spark_rapids_tpu/io/parquet_encode_device.py:116", "parquet_write"),
    "gather_string_spans": (
        "spark_rapids_tpu_torch/csrc/string_gather.cu",
        "spark_rapids_tpu/io/parquet_device.py:1397", "parquet_tpch_q1"),
    "page_decode_codes": (
        "spark_rapids_tpu_torch/csrc/parquet_decode.cu",
        "spark_rapids_tpu/io/parquet_device.py:824", "encoded_q_agg"),
    "delta_expand": (
        "spark_rapids_tpu_torch/csrc/parquet_decode.cu",
        "spark_rapids_tpu/io/parquet_device.py:520", "parquet_v2_xbb_q16"),
    "delta_byte_array": (
        "spark_rapids_tpu_torch/csrc/parquet_delta.cu",
        "spark_rapids_tpu/io/parquet_device.py:548", "parquet_v2_xbb_q16"),
    "k21_flba": (
        "spark_rapids_tpu_torch/csrc/parquet_decode.cu",
        "spark_rapids_tpu/io/parquet_device.py:581", "parquet_v2_xbb_q16"),
    "k21_bss": (
        "spark_rapids_tpu_torch/csrc/parquet_decode.cu",
        "spark_rapids_tpu/io/parquet_device.py:600", "parquet_v2_tpch_q1"),
    "dict_materialize_fixed": (
        "spark_rapids_tpu_torch/csrc/dict_encoded.cu",
        "spark_rapids_tpu/columnar/encoded.py:602", "encoded_q_agg"),
    "dict_materialize_strings": (
        "spark_rapids_tpu_torch/csrc/dict_encoded.cu",
        "spark_rapids_tpu/columnar/encoded.py:614", "encoded_q_join"),
    "remap_codes": (
        "spark_rapids_tpu_torch/csrc/dict_encoded.cu",
        "spark_rapids_tpu/columnar/encoded.py:707", "encoded_q_join"),
    "hash_partition_codes": (
        "spark_rapids_tpu_torch/csrc/hash_partition.cu",
        "spark_rapids_tpu/shuffle/exchange.py:1181", "encoded_q_join"),
    "rlev2_expand": (
        "spark_rapids_tpu_torch/csrc/orc_decode.cu",
        "spark_rapids_tpu/io/orc_device.py:665", "orc_tpch_q1"),
    "present_expand": (
        "spark_rapids_tpu_torch/csrc/orc_decode.cu",
        "spark_rapids_tpu/io/orc_device.py:714", "orc_round_trip"),
    "orc_encode_direct": (
        "spark_rapids_tpu_torch/csrc/orc_encode.cu",
        "spark_rapids_tpu/io/orc_encode_device.py:130", "orc_write"),
    "orc_pack_present": (
        "spark_rapids_tpu_torch/csrc/parquet_encode.cu",
        "spark_rapids_tpu/io/orc_encode_device.py:162", "orc_write"),
    "compact_fixed": (
        "spark_rapids_tpu_torch/csrc/compact_gather.cu",
        "spark_rapids_tpu/columnar/batch.py:1623", "tpch_q1"),
    "gather_fixed": (
        "spark_rapids_tpu_torch/csrc/compact_gather.cu",
        "spark_rapids_tpu/columnar/batch.py:1425", "tpch_q5"),
    "csv_parse_int": (
        "spark_rapids_tpu_torch/csrc/csv_parse.cu",
        "spark_rapids_tpu/io/csv_device.py:285", "csv_tpch_q1"),
    "csv_parse_float": (
        "spark_rapids_tpu_torch/csrc/csv_parse.cu",
        "spark_rapids_tpu/io/csv_device.py:322", "csv_tpch_q1"),
    "csv_parse_datetime": (
        "spark_rapids_tpu_torch/csrc/csv_parse.cu",
        "spark_rapids_tpu/io/csv_device.py:417", "csv_tpch_q1"),
    "csv_null_sentinels": (
        "spark_rapids_tpu_torch/csrc/csv_parse.cu",
        "spark_rapids_tpu/io/csv_device.py:594", "csv_tpch_q1"),
    "string_case_map": (
        "spark_rapids_tpu_torch/csrc/string_transform.cu",
        "spark_rapids_tpu/columnar/strings.py:277", "strings_orders"),
    "string_span_plan": (
        "spark_rapids_tpu_torch/csrc/string_transform.cu",
        "spark_rapids_tpu/columnar/strings.py:571", "strings_orders"),
    "string_replace": (
        "spark_rapids_tpu_torch/csrc/string_transform.cu",
        "spark_rapids_tpu/columnar/strings.py:499", "strings_lineitem"),
    "string_concat": (
        "spark_rapids_tpu_torch/csrc/string_transform.cu",
        "spark_rapids_tpu/columnar/strings.py:642", "strings_lineitem"),
    "format_fixed": (
        "spark_rapids_tpu_torch/csrc/cast_format.cu",
        "spark_rapids_tpu/columnar/format.py:532", "casts_lineitem"),
    "format_float": (
        "spark_rapids_tpu_torch/csrc/cast_format.cu",
        "spark_rapids_tpu/columnar/format.py:284", "casts_lineitem"),
    "parse_float": (
        "spark_rapids_tpu_torch/csrc/cast_parse.cu",
        "spark_rapids_tpu/columnar/parse.py:79", "casts_lineitem"),
    "parse_timestamp": (
        "spark_rapids_tpu_torch/csrc/cast_parse.cu",
        "spark_rapids_tpu/columnar/parse.py:173", "casts_lineitem"),
    "round_robin_route": (
        "spark_rapids_tpu_torch/csrc/hash_partition.cu",
        "spark_rapids_tpu/shuffle/exchange.py:1141", "surface_repartition"),
    "assemble_routed_fixed": (
        "spark_rapids_tpu_torch/csrc/compact_gather.cu",
        "spark_rapids_tpu/shuffle/exchange.py:1433", "surface_repartition"),
    "segment_arg_extreme_string": (
        "spark_rapids_tpu_torch/csrc/string_arg_extreme.cu",
        "spark_rapids_tpu/exec/rowkeys.py:177", "surface_rollup"),
    "stage_program": (
        "spark_rapids_tpu_torch/csrc/stage_program.cu",
        "spark_rapids_tpu/exec/fused.py:351", "tpch_q1"),
}
_GROUP_BY = ("radix_sort_pairs", "group_ids", "segment_reduce",
             "hash_partition")
_Q1 = _GROUP_BY + ("string_hash_words", "string_order_words",
                   "gather_strings")
_Q3 = _GROUP_BY + ("string_compare", "join_build", "join_probe",
                   "join_expand")
_Q5 = _Q3 + ("string_hash_words", "gather_strings")
_JOIN = ("join_build", "join_probe", "join_expand")
_KEYED_JOIN = _GROUP_BY + _JOIN
_STR_KEYS = ("string_hash_words", "gather_strings")
# the kernels each path must launch
_B5 = ("compact_fixed", "gather_fixed")
PATH_KERNELS = {
    "flagship": _GROUP_BY,
    "high_cardinality": _GROUP_BY + ("route_plan",),
    "tpch_q1": _Q1 + _B5,
    "tpch_q6": ("segment_reduce",),
    "tpch_q1_routed": _Q1 + ("route_plan",),
    "tpch_q3": _Q3,
    "tpch_q5": _Q5 + ("gather_fixed",),
    "tpch_q5_shuffled": _Q5 + ("route_plan",),
    "tpch_q2": _KEYED_JOIN + ("string_search", "string_compare"),
    "tpch_q4": _KEYED_JOIN + _STR_KEYS,
    "tpch_q7": _KEYED_JOIN + _STR_KEYS + ("string_compare",),
    "tpch_q8": _KEYED_JOIN + ("string_compare",),
    "tpch_q9": _KEYED_JOIN + _STR_KEYS + ("string_search",),
    "tpch_q10": _KEYED_JOIN + _STR_KEYS + ("string_compare",),
    "tpch_q11": _KEYED_JOIN + ("string_compare",),
    "tpch_q12": _KEYED_JOIN + _STR_KEYS + ("string_compare",),
    "tpch_q13": _KEYED_JOIN + ("string_search",),
    "tpch_q14": _JOIN + ("segment_reduce", "string_search"),
    "tpch_q15": _KEYED_JOIN,
    "tpch_q16": _KEYED_JOIN + _STR_KEYS + ("string_search",
                                           "string_compare"),
    "tpch_q17": _KEYED_JOIN + ("string_compare",),
    "tpch_q18": _KEYED_JOIN + _STR_KEYS,
    "tpch_q19": _JOIN + ("segment_reduce", "string_compare"),
    "tpch_q20": _KEYED_JOIN + ("string_search", "string_compare"),
    "tpch_q21": _KEYED_JOIN + _STR_KEYS + ("string_compare",),
    "tpch_q22": _KEYED_JOIN + _STR_KEYS + ("substring_plan",
                                           "string_compare"),
}
# phase 7: every query sorts, exchanges and aggregates; joins, string
# keys, windows and K17 where its text reaches them
_XBB = ("radix_sort_pairs", "segment_reduce", "hash_partition")
_XBB_JOIN = ("q02", "q03", "q04", "q07", "q08", "q10", "q11", "q12", "q13",
             "q14", "q16", "q17", "q18", "q19", "q20", "q21", "q24", "q26",
             "q27", "q29", "q30")
_XBB_STR_KEYS = ("q07", "q10", "q11", "q14", "q17", "q24", "q27", "q28")
_XBB_EXTRA = {"q05": ("window_segments", "window_rank_offset", "group_ids"),
              "q15": ("window_segments", "window_rank_offset"),
              "q16": ("window_segments", "window_rank_offset",
                      "string_compare"),
              "q26": ("string_compare",),
              "q27": ("string_search", "string_chars"),
              "q28": ("string_chars",)}
for _i in range(1, 31):
    _q = f"q{_i:02d}"
    PATH_KERNELS[f"tpcxbb_{_q}_like"] = (
        _XBB + (_JOIN if _q in _XBB_JOIN else ()) +
        (_STR_KEYS if _q in _XBB_STR_KEYS else ()) + _XBB_EXTRA.get(_q, ()))
PATH_KERNELS["tpcxbb_window_frames"] = _XBB[:1] + _XBB[2:] + (
    "window_segments", "window_frame_agg")
# phase 8: every mortgage query groups by key and, but q_percentiles,
# joins; explode, first and the percentile where the text has them
PATH_KERNELS.update({
    "mortgage_q_delinquency": _KEYED_JOIN,
    "mortgage_q_seller_quarter": _KEYED_JOIN + _STR_KEYS,
    "mortgage_q_delinquency_12": _KEYED_JOIN + ("explode_rows",),
    "mortgage_q_simple_agg": _KEYED_JOIN,
    "mortgage_q_agg_join": _KEYED_JOIN,
    "mortgage_q_percentiles": _GROUP_BY + ("segment_percentile",),
    "mortgage_many_partitions": _GROUP_BY + ("route_plan",),
})
# the Parquet phase: K22 writes; every read decodes levels (K20) and values
# (K21), and STRING columns gather their PLAIN page spans (K7's span entry)
_PQ_READ = ("hybrid_expand", "page_decode_fixed")
PATH_KERNELS.update({
    "parquet_write": ("encode_plain_page",),
    "parquet_tpch_q1": _Q1 + _PQ_READ + ("gather_string_spans",),
    "parquet_tpch_q6": ("segment_reduce",) + _PQ_READ,
    "parquet_tpch_q3": _Q3 + _PQ_READ + ("gather_string_spans",),
    "parquet_tpch_q5": _Q5 + _PQ_READ + ("gather_string_spans",),
    "parquet_decode_shape": ("segment_reduce",) + _PQ_READ,
})
# the Parquet v2 phase: every query reads DELTA pages (K25); FLBA decimals
# (K21's FLBA mode), i_category (DELTA_BYTE_ARRAY: K26) and pr_content
# (DELTA_LENGTH_BYTE_ARRAY) where its text reads them; STRING values
# gather through K7's span entry
_V2_READ = ("hybrid_expand", "delta_expand")
_V2_FLBA = ("q06", "q07", "q08", "q09", "q11", "q13", "q15", "q16", "q17",
            "q18", "q19", "q20", "q21", "q24", "q25", "q26")
_V2_DBA = ("q07", "q10", "q11", "q14", "q16", "q17", "q24", "q26", "q27")
_V2_SPANS = _V2_DBA + ("q28",)
for _i in range(1, 31):
    _q = f"q{_i:02d}"
    PATH_KERNELS[f"parquet_v2_xbb_{_q}"] = _V2_READ + (
        ("k21_flba",) if _q in _V2_FLBA else ()) + (
        ("delta_byte_array",) if _q in _V2_DBA else ()) + (
        ("gather_string_spans",) if _q in _V2_SPANS else ())
PATH_KERNELS.update({
    "parquet_v2_tpch_q1": _Q1[:3] + _V2_READ + ("k21_bss",),
    "parquet_v2_tpch_q6": ("segment_reduce",) + _V2_READ + ("k21_bss",),
})
# the ORC phase: K29 and K22's ORC mode write; every read expands RLEv2
# streams (K27) and spreads values (K21); STRING columns gather their spans
# (K7), or stay encoded (K21's codes mode) where the Hive layout writes
# them DICTIONARY_V2; PRESENT and BOOLEAN streams (K28) where a table has
# NULLs or booleans (the host-table round trip)
_ORC_READ = ("rlev2_expand", "page_decode_fixed")
_ORC_WRITE = ("orc_encode_direct", "orc_pack_present")
PATH_KERNELS.update({
    "orc_write": _ORC_WRITE,
    "orc_round_trip": _ORC_WRITE + _ORC_READ + ("present_expand",
                                                "gather_string_spans"),
    "orc_tpch_q1": _Q1 + _ORC_READ + ("gather_string_spans",),
    "orc_tpch_q6": ("segment_reduce",) + _ORC_READ,
    "orc_tpch_q3": _Q3 + _ORC_READ + ("gather_string_spans",),
    "orc_tpch_q5": _Q5 + _ORC_READ + ("gather_string_spans",),
    "orc_hive_q1": _Q1[:3] + _ORC_READ + ("page_decode_codes",),
    "orc_hive_q6": ("segment_reduce",) + _ORC_READ,
})
# phase 13: the spill, OOM and injected-fault runs (K31 compacts and K32
# gathers in every one; the fallback run's filter and project run on the
# CPU engine, its aggregate on the card)
PATH_KERNELS.update({
    "memory_spill_q5": _Q5 + ("gather_fixed",),
    "memory_spill_q1": _Q1 + _B5,
    "memory_oom_q1": _Q1 + _B5,
    "memory_split": _GROUP_BY + _B5,
    "memory_fallback": ("radix_sort_pairs", "segment_reduce"),
})
# phase 14: every CSV read parses its integers (K33), doubles (K34) and
# dates (K35) on the card; STRING columns match the null spellings (K36)
# and gather their spans (K7's span entry)
_CSV_READ = ("csv_parse_int", "csv_parse_float", "csv_parse_datetime",
             "csv_null_sentinels", "gather_string_spans")
# phase 15: the case maps (K37), trims and substring_index (K38 plans, K7's
# span entry copies), replaces (K39) and concats (K40) where each program's
# text reaches them; the grouped programs group by string keys
_K38 = ("string_span_plan", "gather_string_spans")
PATH_KERNELS.update({
    "strings_lineitem": _GROUP_BY + _STR_KEYS + _K38 + (
        "string_case_map", "string_replace", "string_concat"),
    "strings_orders": _GROUP_BY + _STR_KEYS + _K38 + ("string_case_map",),
    "strings_customer": _K38 + ("string_case_map", "string_replace",
                                "string_concat"),
    "strings_part": _GROUP_BY + _STR_KEYS + _K38 + (
        "string_case_map", "string_replace", "string_concat"),
})
# phase 16: dates, ints and bools formatted (K41), floats formatted (K42)
# and parsed back (K43), timestamps parsed (K44) from concat's text (K40);
# orders' leading digit through SUBSTRING (K13); the grouped programs
# group by string keys
_CASTS = ("format_fixed", "format_float", "parse_float")
PATH_KERNELS.update({
    "casts_lineitem": _GROUP_BY + _STR_KEYS + _CASTS + (
        "parse_timestamp", "string_concat"),
    "casts_orders": _GROUP_BY + _STR_KEYS + _CASTS + (
        "parse_timestamp", "string_concat", "substring_plan"),
    "casts_customer": _CASTS + ("string_replace", "string_concat"),
})
# phase 17: grouping sets reduce STRING min / max with K47 (and BOOL ones
# in K3); round robin routes with K45, routed pieces assemble their fixed
# columns with K46 and their strings with K7
_K47 = ("segment_arg_extreme_string",)
_ROUTED = ("assemble_routed_fixed",)
PATH_KERNELS.update({
    "surface_rollup": _GROUP_BY + _STR_KEYS + _K47,
    "surface_cube": _GROUP_BY + _STR_KEYS + _K47,
    "surface_repartition": _GROUP_BY + _STR_KEYS + _ROUTED + (
        "round_robin_route",),
    "surface_distinct": _GROUP_BY + _STR_KEYS + _ROUTED + ("route_plan",),
    "surface_dedup_pair": _GROUP_BY + _ROUTED + ("route_plan",),
    "surface_dedup_key": _GROUP_BY + _ROUTED + ("route_plan",),
    "surface_range": _GROUP_BY + _ROUTED + ("round_robin_route",),
})
PATH_KERNELS.update({
    "csv_tpch_q1": _Q1 + _CSV_READ,
    "csv_tpch_q6": ("segment_reduce",) + _CSV_READ,
    "csv_tpch_q3": _Q3 + _CSV_READ,
    "csv_tpch_q5": _Q5 + _CSV_READ,
})
# phase 18: the expression programs; K48 runs every path whose plan has
# a computing filter, projection or aggregate input (every query of the
# three suites, over cached tables or files)
PATH_KERNELS.update({name: _GROUP_BY for name in (
    "expr_math", "expr_dates", "expr_shipdates", "expr_bitwise",
    "expr_nulls", "expr_arith")})
PATH_KERNELS["expr_limit_stage"] = ("compact_fixed",)
PATH_KERNELS["expr_expand_stage"] = _GROUP_BY
for _p in list(PATH_KERNELS):
    if _p.startswith(("flagship", "high_cardinality", "tpch_", "tpcxbb_q",
                      "mortgage_q", "csv_tpch_", "orc_tpch_", "orc_hive_q",
                      "parquet_tpch_", "parquet_v2_tpch_",
                      "parquet_v2_xbb_", "expr_", "memory_spill_")):
        PATH_KERNELS[_p] = tuple(PATH_KERNELS[_p]) + ("stage_program",)
TPCH_SF = 10
TPCH_PARTITIONS = 4
TPCH_REL = 1e-9
TPCH_CONF = {"rapids.tpu.sql.test.enabled": True,
             "rapids.tpu.sql.variableFloatAgg.enabled": True}
ALL_SHUFFLED = {"rapids.tpu.sql.autoBroadcastJoinThreshold": 0,
                "rapids.tpu.sql.adaptive.runtimeBroadcastJoin.enabled": False}
C_DEFAULTS = {"rapids.tpu.sql.autoBroadcastJoinThreshold": 10 << 20,
              "rapids.tpu.sql.adaptive.runtimeBroadcastJoin.enabled": True}
# the file phases' warm runs a query: Parquet v2 (cut from 3 to 1 to pay
# for the ORC phase), Parquet and encoded (3 to 1 for phase 13), then all
# of them and ORC's to 0 for phase 13(a)'s q5 beside phase 14. The port
# compiles nothing, so a file query's cold run does a warm run's work: it
# reads the same files from the same page cache (cold and warm sums agreed
# within 5% in every file phase, PERF.md). The timed number of a path is
# then its cold run (best_s).
V2_WARM_REPS = 0
PARQUET_WARM_REPS = 0
ENCODED_WARM_REPS = 0
# phases 7 and 8: warm runs a query, cut from 3 to 2 for phase 13 and
# to 1 for phase 14 beside phase 13(a)'s q5 (the TPCx-BB geomean is then
# of single warm runs)
SUITE_WARM_REPS = 1
# the most seconds q02's SF 5 tables may take to write in the v2 layout
# before q02 is left out of the v2 phase
Q02_V2_MAX_WRITE_S = 30.0
# phase 7: bench.py --tpcxbb's layout (4 partitions, every table cached)
TPCXBB_SF = 10
TPCXBB_PARTITIONS = 4
XBB_SHUFFLE = 8
# q02's self-join on the user emits ~60 x its clicks pairs before its
# filter (3.6e9 at SF 10, ~450M a shuffle partition); it runs at the
# largest scale factor whose pairs fit one card (--q02-probe, PERF.md)
Q02_SF = 5
XBB_SMALL_SF = 0.01
# phase 8: bench.py --mortgage's layout (4 partitions, every table cached)
MORTGAGE_SF = 10
MORTGAGE_PARTITIONS = 4
MORTGAGE_SHUFFLE = 8
# q_delinquency_12 explodes every joined performance row 12 times (1.15e9
# rows at SF 10, 144M a stream batch); it runs at the largest scale factor
# whose explode and group-by fit one card (--mortgage-probe, PERF.md)
MORTGAGE_D12_SF = 4
MORTGAGE_SMALL_SF = 0.01
# the shuffle past K4's shared-memory histogram (4096 buckets)
MANY_PARTITIONS = 5000
MANY_PARTITIONS_SF = 1


def log(msg: str) -> None:
    print(f"[chip_smoke +{time.perf_counter() - T0:7.1f}s] {msg}",
          file=sys.stderr, flush=True)


T0 = time.perf_counter()


class SmokeFailure(AssertionError):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# ---------------------------------------------------------------- timing
def cuda_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


# ------------------------------------------------------------- flagship
def flagship_data(n_rows: int, n_keys: int):
    """bench.py:_build_df's data, exactly."""
    import numpy as np

    rng = np.random.default_rng(42)
    return {
        "k": rng.integers(0, n_keys, n_rows).astype(np.int64),
        "a": rng.integers(-10_000, 10_000, n_rows).astype(np.int64),
        "b": rng.random(n_rows).astype(np.float32),
    }


def flagship_query(df):
    from spark_rapids_tpu_torch.plan import functions as F

    return (df.filter((F.col("a") % 3 != 0) & (F.col("b") < 0.9))
              .withColumn("c", F.col("a") * 2 + 1)
              .groupBy("k")
              .agg(F.sum("c").alias("s"), F.count("*").alias("n"),
                   F.max("a").alias("m")))


def numpy_groupby(data, n_keys: int):
    """Direct numpy group-by of the flagship: (keys, sums, counts, maxes)
    of the groups that keep rows."""
    import numpy as np

    k, a, b = data["k"], data["a"], data["b"]
    keep = (np.fmod(a, 3) != 0) & (b < np.float32(0.9))
    kk, aa = k[keep], a[keep]
    c = aa * 2 + 1
    counts = np.bincount(kk, minlength=n_keys)
    sums = np.bincount(kk, weights=c.astype(np.float64), minlength=n_keys)
    # sort-based max: composite (key, a) sorts each group's max last
    comp = np.sort(kk * 20_000 + (aa + 10_000))
    gkeys = comp // 20_000
    last = np.r_[np.nonzero(np.diff(gkeys))[0], len(comp) - 1]
    maxes = np.zeros(n_keys, dtype=np.int64)
    maxes[gkeys[last]] = comp[last] % 20_000 - 10_000
    present = counts > 0
    keys = np.nonzero(present)[0]
    return (keys, sums[present].astype(np.int64), counts[present],
            maxes[present])


def result_arrays(batches):
    import numpy as np

    cols = list(zip(*[[c.data for c in b.columns] for b in batches]))
    valids = list(zip(*[[c.validity for c in b.columns] for b in batches]))
    arrs = [np.concatenate(c) for c in cols]
    vals = [np.concatenate(v) for v in valids]
    return arrs, vals


def check_flagship(batches, data, n_keys: int, what: str) -> int:
    import numpy as np

    (k, s, n, m), vals = result_arrays(batches)
    check(all(v.all() for v in vals), f"{what}: unexpected NULL in result")
    order = np.argsort(k, kind="stable")
    k, s, n, m = k[order], s[order], n[order], m[order]
    wk, ws, wn, wm = numpy_groupby(data, n_keys)
    check(len(k) == len(wk), f"{what}: {len(k)} groups, numpy {len(wk)}")
    check(np.array_equal(k, wk), f"{what}: group keys differ")
    check(np.array_equal(s, ws), f"{what}: sum(c) differs")
    check(np.array_equal(n, wn), f"{what}: count(*) differs")
    check(np.array_equal(m, wm), f"{what}: max(a) differs")
    return len(k)


def assert_on_device(sess) -> None:
    from spark_rapids_tpu_torch.exec.base import CpuExec

    allowed = {"HostScanExec", "RangeExec", "DeviceToHostExec",
               "HostToDeviceExec", "CpuCoalesceBatchesExec"}
    bad = sess.last_physical_plan.collect_nodes(
        lambda n: isinstance(n, CpuExec) and type(n).__name__ not in allowed)
    check(not bad, f"plan not on the device: {bad}")


def run_flagship(sess, n_rows: int, n_keys: int, what: str, reps: int):
    import torch

    log(f"{what}: generating {n_rows} rows")
    data = flagship_data(n_rows, n_keys)
    df = sess.createDataFrame(
        data, [("k", "long"), ("a", "long"), ("b", "float")],
        num_partitions=2).cache()
    q = flagship_query(df)
    t = time.perf_counter()
    batches = q.toLocalBatches()  # cold: uploads the cache
    torch.cuda.synchronize()
    cold = time.perf_counter() - t
    assert_on_device(sess)
    groups = check_flagship(batches, data, n_keys, what)
    warm = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        batches = q.toLocalBatches()
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t)
    check_flagship(batches, data, n_keys, what)
    log(f"{what}: {groups} groups, cold {cold:.4f} s, warm {warm}")
    return {"rows": n_rows, "keys": n_keys, "groups": groups,
            "cold_s": cold, "warm_s": warm,
            "warm_median_s": statistics.median(warm)}


def profile_flagship(sess, n_rows: int, out_dir: str) -> dict:
    data = flagship_data(n_rows, N_KEYS)
    df = sess.createDataFrame(
        data, [("k", "long"), ("a", "long"), ("b", "float")],
        num_partitions=2).cache()
    q = flagship_query(df)
    q.toLocalBatches()
    return profile_query(q, out_dir, "flagship")


def profile_host(fn, out_dir: str, name: str) -> float:
    """fn() under cProfile, its host functions by cumulative and own time
    written to DIR/{name}_host.txt; returns the wall seconds of that run
    (slowed by cProfile: it ranks host work, it does not time it)."""
    import cProfile
    import io
    import pstats

    import torch

    host = cProfile.Profile()
    t = time.perf_counter()
    host.enable()
    fn()
    torch.cuda.synchronize()
    host.disable()
    wall = time.perf_counter() - t
    text = io.StringIO()
    stats = pstats.Stats(host, stream=text)
    stats.sort_stats("cumulative").print_stats(45)
    stats.sort_stats("tottime").print_stats(25)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{name}_host.txt"), "w") as fh:
        fh.write(f"wall {wall:.6f} s under cProfile\n")
        fh.write(text.getvalue())
    return wall


def profile_query(q, out_dir: str, name: str) -> dict:
    """One warm run of a query under torch.profiler: device time by kernel
    and the device's busy share of the query's wall time; then one under
    cProfile: the host's time by Python function (cProfile slows every
    Python call, so it ranks host work, it does not time it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    q.toLocalBatches()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        q.toLocalBatches()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    events = prof.key_averages()
    # device kernels only: an aten op's row repeats its kernels' time
    dev_us = sum(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
                 for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    table = events.table(sort_by="self_cuda_time_total", row_limit=40)
    with open(os.path.join(out_dir, f"{name}_profile.txt"), "w") as fh:
        fh.write(f"wall {wall:.6f} s, device busy {dev_us / 1e6:.6f} s\n")
        fh.write(table)
    profile_host(q.toLocalBatches, out_dir, name)
    log(f"profile {name}: wall {wall:.4f} s, device kernels "
        f"{dev_us / 1e6:.4f} s")
    return {"wall_s": wall, "device_busy_s": dev_us / 1e6,
            "device_busy_share": dev_us / 1e6 / wall if wall else None}


# -------------------------------------------------------------- TPC-H
def lineitem_columns(df) -> dict:
    """The generated lineitem columns q1 and q6 read (host numpy, all
    partitions)."""
    import numpy as np

    batches = [b for part in df._plan.partitions for b in part]
    out = {}
    for i, attr in enumerate(df.schema):
        cols = [b.columns[i] for b in batches]
        if attr.name in ("l_shipmode", "l_shipinstruct"):
            continue
        if attr.data_type.is_string:
            # q1's keys are one byte each: the UTF-8 bytes are the values
            lens = np.concatenate([np.diff(c.utf8()[0]) for c in cols])
            check(bool((lens == 1).all()), f"{attr.name}: not one byte")
            out[attr.name] = np.concatenate([c.utf8()[1] for c in cols])
        else:
            out[attr.name] = np.concatenate([c.data for c in cols])
    return out


def numpy_q1(li: dict):
    """q1 by numpy: [(flag, status, sums..., avgs..., count)] in ORDER BY
    order, the sums pairwise over each group's rows."""
    import numpy as np

    from spark_rapids_tpu_torch.benchmarks.tpch import _days

    keep = li["l_shipdate"] <= _days("1998-09-02")
    flag, status = li["l_returnflag"][keep], li["l_linestatus"][keep]
    qty, price = li["l_quantity"][keep], li["l_extendedprice"][keep]
    disc, tax = li["l_discount"][keep], li["l_tax"][keep]
    disc_price = price * (1.0 - disc)
    charge = price * (1.0 - disc) * (1.0 + tax)
    key = flag.astype(np.int32) * 256 + status
    rows = []
    for k in np.unique(key):
        m = key == k
        n = int(m.sum())
        sums = [float(np.sum(x[m])) for x in (qty, price, disc_price,
                                              charge, disc)]
        rows.append((chr(k // 256), chr(k % 256), sums[0], sums[1], sums[2],
                     sums[3], sums[0] / n, sums[1] / n, sums[4] / n, n))
    return rows


def numpy_q6(li: dict):
    import numpy as np

    from spark_rapids_tpu_torch.benchmarks.tpch import _days

    d = li["l_shipdate"]
    m = (d >= _days("1994-01-01")) & (d < _days("1995-01-01")) & \
        (li["l_discount"] >= 0.05) & (li["l_discount"] <= 0.07) & \
        (li["l_quantity"] < 24.0)
    return [(float(np.sum(li["l_extendedprice"][m] * li["l_discount"][m])),)]


def check_rows(got, want, what: str) -> float:
    """Rows equal in order: strings and counts exactly, floats within
    TPCH_REL; returns the largest relative float difference."""
    check(len(got) == len(want), f"{what}: {len(got)} rows, numpy "
          f"{len(want)}")
    if got == want:
        return 0.0
    worst = 0.0
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            if isinstance(y, float):
                check(x is not None, f"{what}: NULL where numpy has {y}")
                rel = abs(x - y) / max(abs(y), 1e-300)
                worst = max(worst, rel)
                check(rel <= TPCH_REL, f"{what}: {x} vs numpy {y}")
            else:
                check(x == y, f"{what}: {x!r} vs numpy {y!r}")
    return worst


# the memory layer's counters of work that left the plain device path
FAULT_COUNTERS = ("retries", "splitRetries", "cpuFallbackEvents")


def fault_counts(before: dict) -> dict:
    """FAULT_COUNTERS since `before` (a memory_totals())."""
    d = memory_delta(before)
    return {k: d[k] for k in FAULT_COUNTERS}


def run_query(sess, q, want, what: str, warm_reps: int, cols=None,
              keep_rows: bool = False, faults_ok: bool = False, order=None):
    """One cold and warm_reps warm runs, the plan asserted on the device;
    every run's rows (their columns `cols`, or all; sorted by the key
    function `order` when the query's rows come in no set order) against
    `want`, or (want None) the warm runs' against the cold run's;
    keep_rows: the result holds the rows under "result_rows". Unless
    faults_ok (phase 13), a run that retried, split a batch or ran one on
    the CPU engine fails: no timed run holds work that left the device
    path."""
    import torch

    def pick(rows):
        if order is not None:
            rows = sorted(rows, key=order)
        if want is None or cols is None:
            return rows
        return [tuple(r[i] for i in cols) for r in rows]

    faults = dict.fromkeys(FAULT_COUNTERS, 0)

    def timed():
        before = memory_totals()
        torch.cuda.synchronize()
        t = time.perf_counter()
        rows = q.collect()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        got = fault_counts(before)
        check(faults_ok or not any(got.values()),
              f"{what}: the run left the device path: {got}")
        for k, v in got.items():
            faults[k] += v
        return rows, secs

    rows, cold = timed()
    assert_on_device(sess)
    if want is None:
        want = rows
    worst = check_rows(pick(rows), want, what)
    warm = []
    for _ in range(warm_reps):
        rows, secs = timed()
        warm.append(secs)
        worst = max(worst, check_rows(pick(rows), want, what))
    log(f"{what}: {len(rows)} rows, cold {cold:.4f} s, warm {warm}, "
        f"max rel diff {worst:.3e}")
    out = {"cold_s": cold, "warm_s": warm,
           "warm_median_s": statistics.median(warm) if warm else None,
           "max_rel_diff": worst, "rows": len(rows),
           "fault_counters": faults}
    if keep_rows:
        out["result_rows"] = rows
    return out


def run_tpch(sess, launches: dict, profile_dir=None, wants=None) -> dict:
    """Phase 4: q1, q6 and the routed q1 at TPCH_SF; `wants` gains their
    numpy rows."""
    import torch

    from spark_rapids_tpu_torch import cuda_build as CB
    from spark_rapids_tpu_torch.benchmarks import tpch
    from spark_rapids_tpu_torch.shuffle import exchange as X

    t = time.perf_counter()
    raw = tpch.gen_tables(sess, sf=TPCH_SF, num_partitions=TPCH_PARTITIONS)
    gen_s = time.perf_counter() - t
    li = lineitem_columns(raw["lineitem"])
    n_rows = len(li["l_quantity"])
    log(f"phase 4: SF {TPCH_SF} generated in {gen_s:.1f} s, lineitem "
        f"{n_rows} rows")
    want_q1, want_q6 = numpy_q1(li), numpy_q6(li)
    if wants is not None:
        wants.update(tpch_q1=want_q1, tpch_q6=want_q6)
    tables = {k: v.cache() for k, v in raw.items()}
    out = {"sf": TPCH_SF, "lineitem_rows": n_rows, "gen_s": gen_s}
    for name, query, want, reps in (("tpch_q1", tpch.q1, want_q1, 3),
                                    ("tpch_q6", tpch.q6, want_q6, 3)):
        CB.reset_launch_counts()
        out[name] = run_query(sess, query(tables), want, name, reps)
        launches[name] = CB.launch_counts()
        if name == "tpch_q1":
            out["device_bytes"] = torch.cuda.memory_allocated()
    lazy_cap = X.LAZY_PIECE_CAP_BYTES
    X.LAZY_PIECE_CAP_BYTES = 0
    try:
        CB.reset_launch_counts()
        out["tpch_q1_routed"] = run_query(sess, tpch.q1(tables), want_q1,
                                          "tpch_q1_routed", 0)
        launches["tpch_q1_routed"] = CB.launch_counts()
    finally:
        X.LAZY_PIECE_CAP_BYTES = lazy_cap
    for name in ("tpch_q1", "tpch_q6"):
        out[name]["rows_per_s"] = n_rows / out[name]["warm_median_s"]
    if profile_dir:
        out["q1_profile"] = profile_query(tpch.q1(tables), profile_dir,
                                          "tpch_q1")
    return out, raw, tables, li


def table_columns(df, names) -> dict:
    """Host numpy columns `names` of a generated table (all partitions);
    STRING columns as object arrays."""
    import numpy as np

    batches = [b for part in df._plan.partitions for b in part]
    return {a.name: np.concatenate([b.columns[i].data for b in batches])
            for i, a in enumerate(df.schema) if a.name in names}


def numpy_q3(li: dict, o: dict, c: dict):
    """q3 by numpy: orders and customers are indexed by their keys
    (arange), so each join is a lookup and the aggregate a bincount."""
    import numpy as np

    from spark_rapids_tpu_torch.benchmarks.tpch import _days

    n_ord = len(o["o_orderkey"])
    check(np.array_equal(o["o_orderkey"], np.arange(n_ord)) and
          np.array_equal(c["c_custkey"], np.arange(len(c["c_custkey"]))),
          "q3 reference: primary keys are not arange")
    day = _days("1995-03-15")
    o_ok = (c["c_mktsegment"] == "BUILDING")[o["o_custkey"]] & \
        (o["o_orderdate"] < day)
    lk = li["l_orderkey"]
    keep = (li["l_shipdate"] > day) & o_ok[lk]
    vol = li["l_extendedprice"][keep] * (1.0 - li["l_discount"][keep])
    rev = np.bincount(lk[keep], weights=vol, minlength=n_ord)
    keys = np.nonzero(np.bincount(lk[keep], minlength=n_ord))[0]
    top = keys[np.lexsort((o["o_orderdate"][keys], -rev[keys]))[:10]]
    return [(int(k), int(o["o_orderdate"][k]), int(o["o_shippriority"][k]),
             float(rev[k])) for k in top]


def numpy_q5(li: dict, o: dict, c: dict, s: dict, n: dict, r: dict):
    """q5 by numpy: the ASIA nations' revenue from lineitems whose
    supplier and customer share the nation, orders of 1994."""
    import numpy as np

    from spark_rapids_tpu_torch.benchmarks.tpch import _days

    check(np.array_equal(s["s_suppkey"], np.arange(len(s["s_suppkey"]))) and
          np.array_equal(n["n_nationkey"], np.arange(len(n["n_nationkey"]))),
          "q5 reference: primary keys are not arange")
    asia = np.isin(n["n_regionkey"], r["r_regionkey"][r["r_name"] == "ASIA"])
    o_ok = (o["o_orderdate"] >= _days("1994-01-01")) & \
        (o["o_orderdate"] < _days("1995-01-01"))
    ls, lo = li["l_suppkey"], li["l_orderkey"]
    nation = s["s_nationkey"][ls]
    keep = asia[nation] & o_ok[lo] & \
        (c["c_nationkey"][o["o_custkey"][lo]] == nation)
    vol = li["l_extendedprice"][keep] * (1.0 - li["l_discount"][keep])
    n_nat = len(asia)
    rev = np.bincount(nation[keep], weights=vol, minlength=n_nat)
    keys = np.nonzero(np.bincount(nation[keep], minlength=n_nat))[0]
    keys = keys[np.argsort(-rev[keys], kind="stable")]
    return [(n["n_name"][k], float(rev[k])) for k in keys]


def join_strategies(sess) -> list:
    """How each hash join of the last query ran: broadcast (planned),
    shuffled, or shuffled demoted to a broadcast by the runtime probe."""
    from spark_rapids_tpu_torch.exec import join as J

    out = []
    for j in sess.last_physical_plan.collect_nodes(
            lambda x: isinstance(x, J._JoinBase)):
        if isinstance(j, J.TpuNestedLoopJoinExec):
            ran = "nested loop (cross)"
        elif isinstance(j, J.TpuBroadcastHashJoinExec):
            ran = "broadcast"
        elif j.metrics[J.RUNTIME_BROADCASTS]:
            ran = "shuffled->broadcast (runtime probe"
            ran += ", build side swapped)" if j.build_left else ")"
        else:
            ran = "shuffled"
        out.append({"join": f"{j.left_keys!r} = {j.right_keys!r}",
                    "ran_as": ran})
    return out


def run_joins(sess, raw, tables, li: dict, launches: dict,
              profile_dir=None, wants=None) -> dict:
    """Phase 5: q3, q5 and the all-shuffled q5 over phase 4's tables;
    `wants` gains their numpy rows and input rows."""
    from spark_rapids_tpu_torch import cuda_build as CB
    from spark_rapids_tpu_torch.benchmarks import tpch

    o = table_columns(raw["orders"], ("o_orderkey", "o_custkey",
                                      "o_orderdate", "o_shippriority"))
    c = table_columns(raw["customer"], ("c_custkey", "c_mktsegment",
                                        "c_nationkey"))
    s = table_columns(raw["supplier"], ("s_suppkey", "s_nationkey"))
    n = table_columns(raw["nation"], ("n_nationkey", "n_regionkey",
                                      "n_name"))
    r = table_columns(raw["region"], ("r_regionkey", "r_name"))
    want = {"tpch_q3": numpy_q3(li, o, c),
            "tpch_q5": numpy_q5(li, o, c, s, n, r)}
    n_li, n_ord = len(li["l_orderkey"]), len(o["o_orderkey"])
    n_cust, n_supp = len(c["c_custkey"]), len(s["s_suppkey"])
    input_rows = {"tpch_q3": n_li + n_ord + n_cust,
                  "tpch_q5": n_li + n_ord + n_cust + n_supp + 25 + 5}
    if wants is not None:
        wants.update(want)
        wants["input_rows"] = {"q1": n_li, "q6": n_li,
                               "q3": input_rows["tpch_q3"],
                               "q5": input_rows["tpch_q5"]}
    out = {"orders_rows": n_ord, "customer_rows": n_cust,
           "supplier_rows": n_supp}
    runs = (("tpch_q3", tpch.q3, "tpch_q3", 3, {}),
            ("tpch_q5", tpch.q5, "tpch_q5", 3, {}),
            ("tpch_q5_shuffled", tpch.q5, "tpch_q5", 0, ALL_SHUFFLED))
    for name, query, ref, reps, conf in runs:
        for k, v in conf.items():
            sess.set_conf(k, v)
        try:
            CB.reset_launch_counts()
            out[name] = run_query(sess, query(tables), want[ref], name,
                                  reps)
            launches[name] = CB.launch_counts()
            joins = join_strategies(sess)
        finally:
            for k in conf:
                sess.set_conf(k, C_DEFAULTS[k])
        out[name]["joins"] = joins
        ran = [j["ran_as"] for j in joins]
        log(f"{name} joins: {joins}")
        if conf:
            check(all(x == "shuffled" for x in ran),
                  f"{name}: not every join shuffled: {ran}")
        else:
            check(any(x == "shuffled" for x in ran) and
                  any("broadcast" in x for x in ran),
                  f"{name}: needs a shuffled and a broadcast join: {ran}")
            out[name]["rows_per_s"] = input_rows[ref] / \
                out[name]["warm_median_s"]
        out[name]["input_rows"] = input_rows[ref]
    if profile_dir:
        for name, query in (("tpch_q3", tpch.q3), ("tpch_q5", tpch.q5)):
            out[name]["profile"] = profile_query(query(tables), profile_dir,
                                                 name)
    return out


# ------------------------------------------------- phase 6 (slice 4)
NEW_QUERIES = ("q2", "q4", "q7", "q8", "q9", "q10", "q11", "q12", "q13",
               "q14", "q15", "q16", "q17", "q18", "q19", "q20", "q21", "q22")
# the tables each query reads (rows per second counts all of their rows)
QUERY_TABLES = {
    "q2": "part partsupp supplier nation region", "q4": "orders lineitem",
    "q7": "lineitem orders customer supplier nation",
    "q8": "lineitem orders customer supplier part nation region",
    "q9": "lineitem orders supplier part partsupp nation",
    "q10": "customer orders lineitem nation",
    "q11": "partsupp supplier nation", "q12": "orders lineitem",
    "q13": "customer orders", "q14": "lineitem part",
    "q15": "lineitem supplier", "q16": "partsupp part supplier",
    "q17": "lineitem part", "q18": "customer orders lineitem",
    "q19": "lineitem part", "q20": "lineitem part partsupp supplier nation",
    "q21": "lineitem orders supplier nation", "q22": "customer orders"}
# all 22 queries on the card against the CPU engine
SMALL_SF = 0.1


def pool_index(df, name: str, pool) -> "object":
    """Per row of a generated STRING column whose values all come from
    `pool`: the value's index in the pool, from its UTF-8 bytes (length
    and the fewest leading bytes, at most five, that tell the pool's
    values apart)."""
    import numpy as np

    enc = [v.encode() for v in pool]
    width = next((k for k in range(6)
                  if len({(len(b), b[:k]) for b in enc}) == len(enc)), None)
    check(width is not None, f"{name}: pool keys clash")

    def key_of(lens, first):
        key = lens.astype(np.int64) << 40
        for j, b in enumerate(first):
            key |= b.astype(np.int64) << (8 * (4 - j))
        return key

    pool_keys = key_of(np.array([len(b) for b in enc]),
                       [np.array([b[j] if j < len(b) else 0 for b in enc])
                        for j in range(width)])
    order = np.argsort(pool_keys)
    sorted_keys = pool_keys[order]
    col = [a.name for a in df.schema].index(name)
    out = []
    for part in df._plan.partitions:
        for b in part:
            offs, raw = b.columns[col].utf8()
            offs = offs.astype(np.int64)
            lens = np.diff(offs)
            first = [np.where(j < lens, raw[np.minimum(
                offs[:-1] + j, max(len(raw) - 1, 0))], 0)
                for j in range(width)]
            key = key_of(lens, first)
            at = np.minimum(np.searchsorted(sorted_keys, key), len(pool) - 1)
            check(bool((sorted_keys[at] == key).all()),
                  f"{name}: a value outside the pool")
            out.append(order[at])
    return np.concatenate(out)


def numpy_q12(li: dict, shipmode, priority):
    """q12 by numpy: orders are indexed by their keys, so the join is a
    lookup; counts per ship mode of high (1-URGENT, 2-HIGH) and low
    priority lines."""
    import numpy as np

    from spark_rapids_tpu_torch.benchmarks.tpch import (
        _PRIORITIES,
        _SHIPMODES,
        _days,
    )

    modes = [_SHIPMODES.index("MAIL"), _SHIPMODES.index("SHIP")]
    rd, cd = li["l_receiptdate"], li["l_commitdate"]
    m = np.isin(shipmode, modes) & (cd < rd) & (li["l_shipdate"] < cd) & \
        (rd >= _days("1994-01-01")) & (rd < _days("1995-01-01"))
    high = np.isin(priority[li["l_orderkey"][m]],
                   [_PRIORITIES.index("1-URGENT"),
                    _PRIORITIES.index("2-HIGH")])
    sm = shipmode[m]
    rows = []
    for k in sorted(np.unique(sm), key=lambda i: _SHIPMODES[i]):
        sel = sm == k
        rows.append((_SHIPMODES[k], int(high[sel].sum()),
                     int((~high[sel]).sum())))
    return rows


def numpy_q13(o: dict, n_cust: int, comment):
    """q13 by numpy: orders per customer without 'special' and 'requests'
    in the comment (0 for none: the left join), then customers per count,
    by count of customers and count, both descending."""
    import numpy as np

    from spark_rapids_tpu_torch.benchmarks.tpch import _O_COMMENTS

    bad = [i for i, v in enumerate(_O_COMMENTS)
           if "special" in v and "requests" in v]
    keep = ~np.isin(comment, bad)
    cnt = np.bincount(o["o_custkey"][keep], minlength=n_cust)
    dist = np.bincount(cnt)
    keys = np.nonzero(dist)[0]
    keys = keys[np.lexsort((-keys, -dist[keys]))]
    return [(int(k), int(dist[k])) for k in keys]


def numpy_q14(li: dict, p_type):
    """q14 by numpy: parts are indexed by their keys; the PROMO share of
    one month's revenue."""
    import numpy as np

    from spark_rapids_tpu_torch.benchmarks.tpch import _TYPES, _days

    d = li["l_shipdate"]
    m = (d >= _days("1995-09-01")) & (d < _days("1995-10-01"))
    vol = li["l_extendedprice"][m] * (1.0 - li["l_discount"][m])
    promo = np.array([t.startswith("PROMO") for t in _TYPES])[
        p_type[li["l_partkey"][m]]]
    return [(100.0 * float(np.sum(np.where(promo, vol, 0.0))) /
             float(np.sum(vol)),)]


def numpy_q22(c: dict, o: dict):
    """q22 by numpy: customers of seven country codes (the phone's first
    two characters) with a balance above those codes' average positive
    balance and no order; count and balance per code."""
    import numpy as np

    codes = ("13", "31", "23", "29", "30", "18", "17")
    cc = np.array([p[:2] for p in c["c_phone"]], dtype=object)
    sel = np.isin(cc, codes)
    bal = c["c_acctbal"]
    pos = sel & (bal > 0.0)
    avg = float(np.sum(bal[pos])) / int(pos.sum())
    has_order = np.bincount(o["o_custkey"],
                            minlength=len(c["c_custkey"])) > 0
    keep = sel & (bal > avg) & ~has_order
    rows = []
    for code in sorted(set(cc[keep])):
        m = keep & (cc == code)
        rows.append((code, int(m.sum()), float(np.sum(bal[m]))))
    return rows


def run_queries(sess, raw, tables, li: dict, launches: dict,
                profile_dir=None, wants=None) -> dict:
    """Phase 6: the other 18 queries over phase 4's cached SF 10 tables,
    one cold and 3 warm runs each; q12, q13, q14 and q22 against numpy
    (`wants` gains q12's numpy rows)."""
    import numpy as np

    from spark_rapids_tpu_torch import cuda_build as CB
    from spark_rapids_tpu_torch.benchmarks import tpch

    o = table_columns(raw["orders"], ("o_orderkey", "o_custkey"))
    c = table_columns(raw["customer"], ("c_custkey", "c_acctbal",
                                        "c_phone"))
    p = table_columns(raw["part"], ("p_partkey",))
    for keys in (o["o_orderkey"], c["c_custkey"], p["p_partkey"]):
        check(np.array_equal(keys, np.arange(len(keys))),
              "phase 6 reference: primary keys are not arange")
    pools = {"pool_l_shipmode": pool_index(raw["lineitem"], "l_shipmode",
                                           tpch._SHIPMODES),
             "pool_o_orderpriority": pool_index(
                 raw["orders"], "o_orderpriority", tpch._PRIORITIES),
             "pool_p_type": pool_index(raw["part"], "p_type", tpch._TYPES)}
    want = {
        "q12": numpy_q12(li, pools["pool_l_shipmode"],
                         pools["pool_o_orderpriority"]),
        "q13": numpy_q13(o, len(c["c_custkey"]),
                         pool_index(raw["orders"], "o_comment",
                                    tpch._O_COMMENTS)),
        "q14": numpy_q14(li, pools["pool_p_type"]),
        "q22": numpy_q22(c, o)}
    log(f"phase 6: numpy references of {sorted(want)} ready")
    if wants is not None:
        wants["tpch_q12"] = want["q12"]
        wants["pools"] = pools
    table_rows = {k: sum(b.num_rows for part in v._plan.partitions
                         for b in part) for k, v in raw.items()}
    out = {"table_rows": table_rows}
    for q in NEW_QUERIES:
        name = f"tpch_{q}"
        CB.reset_launch_counts()
        out[name] = run_query(sess, tpch.QUERIES[q](tables), want.get(q),
                              name, 3)
        launches[name] = CB.launch_counts()
        joins = join_strategies(sess)
        out[name]["joins"] = joins
        log(f"{name} joins: {joins}")
        rows_in = sum(table_rows[t] for t in QUERY_TABLES[q].split())
        out[name]["input_rows"] = rows_in
        out[name]["rows_per_s"] = rows_in / out[name]["warm_median_s"]
        out[name]["checked_against"] = "numpy" if q in want else \
            "its own cold run"
    if profile_dir:
        slow = sorted(NEW_QUERIES, key=lambda q: -out[f"tpch_{q}"][
            "warm_median_s"])[:2]
        for q in slow:
            out[f"tpch_{q}"]["profile"] = profile_query(
                tpch.QUERIES[q](tables), profile_dir, f"tpch_{q}")
    return out


def run_small_sf() -> dict:
    """All 22 queries at SMALL_SF on the card against the port's own numpy
    CPU engine (rapids.tpu.sql.enabled=false: the same planner, none of
    the device kernels), rows in order, DOUBLE within TPCH_REL."""
    import spark_rapids_tpu_torch as srt
    from spark_rapids_tpu_torch.benchmarks import tpch

    card = srt.new_session(TPCH_CONF)
    host = srt.new_session({"rapids.tpu.sql.variableFloatAgg.enabled": True,
                            "rapids.tpu.sql.enabled": False}, device="cpu")
    tabs = []
    for sess in (card, host):
        sess.set_conf("rapids.tpu.sql.shuffle.partitions", 8)
        tabs.append({k: v.cache() for k, v in tpch.gen_tables(
            sess, sf=SMALL_SF, num_partitions=TPCH_PARTITIONS).items()})
    out = {"sf": SMALL_SF}
    for q, fn in tpch.QUERIES.items():
        t = time.perf_counter()
        got = fn(tabs[0]).collect()
        card_s = time.perf_counter() - t
        assert_on_device(card)
        t = time.perf_counter()
        want = fn(tabs[1]).collect()
        host_s = time.perf_counter() - t
        worst = check_rows(got, want, f"{q} at SF {SMALL_SF} vs the CPU "
                           "engine")
        out[q] = {"rows": len(got), "card_s": card_s, "cpu_engine_s": host_s,
                  "max_rel_diff": worst}
    log(f"phase 6: all 22 queries at SF {SMALL_SF} equal the CPU engine: "
        + ", ".join(f"{q} {v['rows']}" for q, v in out.items()
                    if q != "sf"))
    # phase 15's programs on the same tables, incompatibleOps on the card
    # (the rows are ASCII, so the case maps agree with Python's)
    from spark_rapids_tpu_torch.plan import functions as F

    for k, v in STRING_CONF.items():
        card.set_conf(k, v)
    for name, fn in STRING_PROGRAMS.items():
        key = STRING_KEYS[name]
        got = sorted(fn(tabs[0], F).collect(), key=lambda r: r[:key])
        assert_on_device(card)
        want = sorted(fn(tabs[1], F).collect(), key=lambda r: r[:key])
        out[name] = {"rows": len(got), "max_rel_diff": check_rows(
            got, want, f"{name} at SF {SMALL_SF} vs the CPU engine")}
    log(f"phase 15: the four programs at SF {SMALL_SF} equal the CPU "
        "engine: " + ", ".join(f"{q} {out[q]['rows']}"
                               for q in STRING_PROGRAMS))
    # phase 16's programs, the cast keys on for the card
    for k, v in CAST_CONF.items():
        card.set_conf(k, v)
    for name, fn in CAST_PROGRAMS.items():
        key = CAST_KEYS[name]
        got = sorted(fn(tabs[0], F).collect(), key=lambda r: r[:key])
        assert_on_device(card)
        want = sorted(fn(tabs[1], F).collect(), key=lambda r: r[:key])
        out[name] = {"rows": len(got), "max_rel_diff": check_rows(
            got, want, f"{name} at SF {SMALL_SF} vs the CPU engine")}
    log(f"phase 16: the three programs at SF {SMALL_SF} equal the CPU "
        "engine: " + ", ".join(f"{q} {out[q]['rows']}"
                               for q in CAST_PROGRAMS))
    for k in CAST_CONF:
        card.set_conf(k, False)
    # phase 17's programs (rows sorted, NULLs first)
    for name, fn in SURFACE_PROGRAMS.items():
        t = time.perf_counter()
        got = sorted_rows(fn(card, tabs[0], F, SMALL_SF).collect())
        assert_on_device(card)
        card_s = time.perf_counter() - t
        t = time.perf_counter()
        want = sorted_rows(fn(host, tabs[1], F, SMALL_SF).collect())
        out[name] = {"rows": len(got), "card_s": card_s,
                     "cpu_engine_s": time.perf_counter() - t,
                     "max_rel_diff": check_rows(
                         got, want, f"{name} at SF {SMALL_SF} vs the CPU "
                         "engine")}
    log(f"phase 17: the seven programs at SF {SMALL_SF} equal the CPU "
        "engine: " + ", ".join(f"{q} {out[q]['rows']}"
                               for q in SURFACE_PROGRAMS))
    # phase 18's programs (math on the card under incompatibleOps)
    for k, v in EXPR_CONF.items():
        card.set_conf(k, v)
    for name, fn in EXPR_PROGRAMS.items():
        got = fn(tabs[0], F).collect()
        assert_on_device(card)
        want = fn(tabs[1], F).collect()
        out[name] = {"rows": len(got), "max_rel_diff": check_rows(
            got, want, f"{name} at SF {SMALL_SF} vs the CPU engine")}
    log(f"phase 18: the {len(EXPR_PROGRAMS)} programs at SF {SMALL_SF} "
        "equal the CPU engine: " + ", ".join(
            f"{q} {out[q]['rows']}" for q in EXPR_PROGRAMS))
    return out


# ------------------------------------------------------------ TPCx-BB
class TableRecorder(dict):
    """The tables dict of a query, recording which tables it reads."""

    def __init__(self, tables):
        super().__init__(tables)
        self.seen = set()

    def __getitem__(self, k):
        self.seen.add(k)
        return super().__getitem__(k)


def host_columns(df, names) -> dict:
    """Host numpy columns `names` of a generated table (all partitions;
    DECIMAL as unscaled int64)."""
    import numpy as np

    batches = [b for part in df._plan.partitions for b in part]
    idx = {a.name: i for i, a in enumerate(df.schema)}
    return {n: np.concatenate([b.columns[idx[n]].data for b in batches])
            for n in names}


def numpy_xbb_q16(ss: dict, item: dict):
    """q16 by numpy: per store the decimal revenue before / after the
    pivot and in total, summed in int64 cents, ranked by total desc,
    store; the rows with rank <= 20 as (store, before, after, total, rank,
    delta), the money as Decimal."""
    from decimal import Decimal

    import numpy as np

    from spark_rapids_tpu_torch.benchmarks.tpcxbb import _secs

    cat = item["i_category"]
    keep_cat = np.isin(cat, ["BOOKS", "ELECTRONICS", "HOME"])
    m = keep_cat[ss["ss_item_sk"]]
    store = ss["ss_store_sk"][m]
    paid = ss["ss_net_paid"][m]
    early = ss["ss_sold_ts"][m] < _secs("2003-07-01T00:00:00") * 1_000_000
    n_store = int(store.max()) + 1 if len(store) else 0

    def total(w):
        out = np.zeros(n_store, dtype=np.int64)
        np.add.at(out, store, w)
        return out

    before = total(np.where(early, paid, 0))
    after = total(np.where(early, 0, paid))
    tot = total(paid)
    present = np.bincount(store, minlength=n_store) > 0
    stores = np.nonzero(present)[0]
    order = np.lexsort((stores, -tot[stores]))
    rows = []
    rank = 0
    for i, s in enumerate(stores[order]):
        if i == 0 or tot[s] != tot[stores[order][i - 1]]:
            rank = i + 1
        if rank > 20:
            break
        check(before[s] + after[s] == tot[s], "q16 numpy: before + after")
        cents = (before[s], after[s], tot[s], after[s] - before[s])
        b, a, tt, d = (Decimal(int(c)).scaleb(-2) for c in cents)
        rows.append((int(s), b, a, tt, rank, d))
    return rows


def click_key(user, ts):
    """One int64 sort key of (user, click second in 2003): users are below
    2^20 at SF 10, seconds of the year below 2^25."""
    from spark_rapids_tpu_torch.benchmarks.tpcxbb import _secs

    return user * (1 << 25) + (ts // 1_000_000 - _secs("2003-01-01T00:00:00"))


def clicks_by_user(wcs: dict):
    """The clicks sorted by (user, click time) and the start of each
    user's run."""
    import numpy as np

    order = np.argsort(click_key(wcs["wcs_user_sk"], wcs["wcs_click_ts"]),
                       kind="stable")
    user = wcs["wcs_user_sk"][order]
    ts = wcs["wcs_click_ts"][order]
    item = wcs["wcs_item_sk"][order]
    first = np.ones(len(user), dtype=bool)
    first[1:] = user[1:] != user[:-1]
    return user, ts, item, first


def numpy_xbb_q05(sorted_clicks):
    """q05 by numpy: sessions (gaps over an hour + 1) and clicks per user,
    clicks > 1, top 100 by sessions desc, user."""
    import numpy as np

    user, ts, _, first = sorted_clicks
    secs = ts // 1_000_000
    gap = np.zeros(len(secs), dtype=np.int64)
    gap[1:] = secs[1:] - secs[:-1]
    gap[first] = 0
    starts = np.nonzero(first)[0]
    users = user[starts]
    clicks = np.diff(np.append(starts, len(user)))
    sessions = np.add.reduceat((gap > 3600).astype(np.int64), starts) + 1
    keep = clicks > 1
    users, clicks, sessions = users[keep], clicks[keep], sessions[keep]
    order = np.lexsort((users, -sessions))[:100]
    return [(int(users[i]), int(sessions[i]), int(clicks[i]))
            for i in order]


def numpy_xbb_q01(ss: dict, n_item: int):
    """q01 by numpy: per (store, item) count and quantity, count >= 2, top
    100 by count desc, store, item."""
    import numpy as np

    key = ss["ss_store_sk"] * n_item + ss["ss_item_sk"]
    keys, inv, cnt = np.unique(key, return_inverse=True, return_counts=True)
    qty = np.bincount(inv, weights=ss["ss_quantity"]).astype(np.int64)
    keep = cnt >= 2
    keys, cnt, qty = keys[keep], cnt[keep], qty[keep]
    order = np.lexsort((keys, -cnt))[:100]
    return [(int(keys[i] // n_item), int(keys[i] % n_item), int(cnt[i]),
             int(qty[i])) for i in order]


def numpy_xbb_q28(pr: dict, lengths):
    """q28 by numpy: per (split, label) review count and mean text
    length, ordered by split, label."""
    import numpy as np

    split = np.where(pr["pr_review_sk"] % 10 < 9, "train", "test")
    label = (pr["pr_rating"] >= 4).astype(np.int64)
    rows = []
    for s in ("test", "train"):
        for lab in (0, 1):
            m = (split == s) & (label == lab)
            n = int(m.sum())
            if n:
                rows.append((s, lab, n, float(lengths[m].sum()) / n))
    return rows


def numpy_running_items(sorted_clicks):
    """The frames path's running sum by numpy: per user the cumulative
    item keys up to the row's last peer (same click time)."""
    import numpy as np

    user, ts, item, first = sorted_clicks
    cs = np.cumsum(item)
    starts = np.nonzero(first)[0]
    base = np.repeat(np.append(0, cs)[starts],
                     np.diff(np.append(starts, len(user))))
    run = cs - base
    last = np.ones(len(user), dtype=bool)
    last[:-1] = (user[1:] != user[:-1]) | (ts[1:] != ts[:-1])
    ends = np.nonzero(last)[0]
    peer_last = np.repeat(ends, np.diff(np.append(-1, ends)))
    return run[peer_last]


def gen_xbb(sess, sf: float):
    from spark_rapids_tpu_torch.benchmarks import tpcxbb

    t = time.perf_counter()
    raw = tpcxbb.gen_tables(sess, sf=sf, num_partitions=TPCXBB_PARTITIONS)
    gen_s = time.perf_counter() - t
    rows = {k: sum(b.num_rows for part in v._plan.partitions for b in part)
            for k, v in raw.items()}
    log(f"phase 7: TPCx-BB SF {sf} generated in {gen_s:.1f} s: {rows}")
    return raw, {k: v.cache() for k, v in raw.items()}, rows, gen_s


def xbb_session():
    """A session laid out as bench.py --tpcxbb and --mortgage run their
    suites (8 shuffle partitions, float aggregation on)."""
    import spark_rapids_tpu_torch as srt

    sess = srt.new_session(TPCH_CONF)
    sess.set_conf("rapids.tpu.sql.shuffle.partitions", XBB_SHUFFLE)
    return sess


def release(sess, tables) -> None:
    import torch

    for df in tables.values():
        df.unpersist()
    sess.last_physical_plan = None
    torch.cuda.empty_cache()


def probe_memory(sfs, gen, table: str, query_of, label: str) -> list:
    """One query alone at each scale factor in `sfs` (ascending), on its
    own cached tables as its phase lays them out (4 partitions, 8 shuffle
    partitions): per scale factor the device bytes its tables hold, then
    the time, rows, peak device bytes and FAULT_COUNTERS of three runs,
    up to the first that runs out of device memory. `gen` makes the tables, `table` is the
    one uploaded before the runs. The readings that set Q02_SF and
    MORTGAGE_D12_SF."""
    import torch

    from spark_rapids_tpu_torch.engine import retry as R
    from spark_rapids_tpu_torch.plan import functions as F

    out = []
    for sf in sfs:
        sess = xbb_session()
        raw, tables, rows, gen_s = gen(sess, sf)
        tables[table].agg(F.count("*")).collect()
        q = query_of(tables)
        r = {"sf": sf, "input_rows": rows[table], "gen_s": gen_s,
             "tables_bytes": torch.cuda.memory_allocated(), "runs": []}
        out.append(r)
        for _ in range(3):
            torch.cuda.reset_peak_memory_stats()
            before = memory_totals()
            t = time.perf_counter()
            try:
                n = len(q.collect())
                torch.cuda.synchronize()
            except (torch.OutOfMemoryError, R.TpuRetryOOM) as e:
                # the memory layer's escalation names the site
                r["out_of_memory"] = str(e).splitlines()[0]
                r["peak_bytes"] = torch.cuda.max_memory_allocated()
                break
            # a run that fits only through retries, splits or the CPU
            # engine says so
            r["runs"].append({"s": time.perf_counter() - t, "rows": n,
                              "peak_bytes":
                              torch.cuda.max_memory_allocated(),
                              "fault_counters": fault_counts(before)})
        log(f"{label} probe at SF {sf}: {r}")
        del q, raw
        release(sess, tables)
        if "out_of_memory" in r:
            break
    return out


def probe_q02(sfs) -> list:
    """TPCx-BB q02 by scale factor (its self-join's pairs, PERF.md)."""
    from spark_rapids_tpu_torch.benchmarks import tpcxbb

    return probe_memory(sfs, gen_xbb, "web_clickstreams", tpcxbb.q02_like,
                        "q02")


def best_s(r: dict) -> float:
    """A path's time: its warm median, or its cold run where it ran no
    warm run."""
    return r["cold_s"] if r["warm_median_s"] is None else r["warm_median_s"]


def last_s(r: dict) -> float:
    """The seconds of a path's last run."""
    return (r["warm_s"] or [r["cold_s"]])[-1]


def run_xbb_query(sess, name, fn, tables, table_rows, want, launches,
                  warm_reps: int, cols=None, keep_rows: bool = False) -> dict:
    from spark_rapids_tpu_torch import cuda_build as CB

    rec = TableRecorder(tables)
    q = fn(rec)
    CB.reset_launch_counts()
    r = run_query(sess, q, want, name, warm_reps, cols, keep_rows)
    launches[name] = CB.launch_counts()
    rows_in = sum(table_rows[t] for t in sorted(rec.seen))
    r["tables"] = sorted(rec.seen)
    r["input_rows"] = rows_in
    r["rows_per_s"] = rows_in / best_s(r)
    r["joins"] = join_strategies(sess)
    return r


def run_tpcxbb(launches: dict, profile_dir=None):
    """Phase 7: all 30 TPCx-BB-like queries (q02 at Q02_SF, see PERF.md)
    and the window-frames path over cached SF 10 tables; returns the
    results and pr_content's host column (for K17's timing)."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch import cuda_build as CB
    from spark_rapids_tpu_torch.benchmarks import tpcxbb

    sess = xbb_session()
    out = {"sf": TPCXBB_SF, "q02_sf": Q02_SF}
    # q02 alone at its cut scale factor (its self-join's pairs, PERF.md)
    raw, tables, rows, _ = gen_xbb(sess, Q02_SF)
    torch.cuda.reset_peak_memory_stats()
    r = run_xbb_query(sess, "tpcxbb_q02_like", tpcxbb.q02_like, tables,
                      rows, None, launches, SUITE_WARM_REPS, keep_rows=True)
    r["sf"] = Q02_SF
    r["peak_bytes"] = torch.cuda.max_memory_allocated()
    r["checked_against"] = "its own cold run"
    out["tpcxbb_q02_like"] = r
    log(f"tpcxbb_q02_like at SF {Q02_SF}: peak device bytes "
        f"{r['peak_bytes']}")
    # the Parquet v2 phase's q02, on the same SF 5 tables
    v2 = {(k if k.startswith("parquet_v2_") or k == "left_out" else
           f"q02_sf{Q02_SF}_{k}"): v for k, v in run_parquet_v2_xbb(
               sess, raw, {"tpcxbb_q02_like": r.pop("result_rows")}, rows,
               launches, ["q02_like"], V2_WARM_REPS,
               max_write_s=Q02_V2_MAX_WRITE_S,
               profile_dir=profile_dir).items()}
    del raw
    release(sess, tables)

    raw, tables, rows, gen_s = gen_xbb(sess, TPCXBB_SF)
    out["gen_s"] = gen_s
    out["table_rows"] = rows
    ss = host_columns(raw["store_sales"], (
        "ss_sold_ts", "ss_store_sk", "ss_item_sk", "ss_quantity",
        "ss_net_paid"))
    item_batches = [b for p in raw["item"]._plan.partitions for b in p]
    item = {"i_category": np.concatenate([b.columns[1].data
                                          for b in item_batches])}
    wcs = host_columns(raw["web_clickstreams"], (
        "wcs_user_sk", "wcs_click_ts", "wcs_item_sk"))
    pr = host_columns(raw["product_reviews"], ("pr_review_sk", "pr_rating"))
    from spark_rapids_tpu_torch.columnar.batch import HostColumnVector

    pr_batches = [b for p in raw["product_reviews"]._plan.partitions
                  for b in p]
    pr_content = HostColumnVector.from_numpy(np.concatenate(
        [b.columns[4].data for b in pr_batches]))
    lengths = np.diff(pr_content.utf8()[0])
    t = time.perf_counter()
    sorted_clicks = clicks_by_user(wcs)
    want = {"q16_like": numpy_xbb_q16(ss, item),
            "q05_like": numpy_xbb_q05(sorted_clicks),
            "q01_like": numpy_xbb_q01(ss, rows["item"]),
            "q28_like": numpy_xbb_q28(pr, lengths)}
    running = numpy_running_items(sorted_clicks)
    log(f"phase 7: numpy references of {sorted(want)} and the running sum "
        f"ready in {time.perf_counter() - t:.1f} s")
    del ss, wcs, pr, item
    for name in sorted(tpcxbb.QUERIES):
        if name == "q02_like":
            continue
        path = f"tpcxbb_{name}"
        fn = tpcxbb.QUERIES[name]
        r = run_xbb_query(sess, path, fn, tables, rows, want.get(name),
                          launches, SUITE_WARM_REPS, keep_rows=True)
        r["checked_against"] = "numpy" if name in want else \
            "its own cold run"
        if name == "q16_like":
            for _, before, after, total, _, delta in fn(tables).collect():
                check(before + after == total and after - before == delta,
                      f"{path}: before + after != total")
            r["checked_against"] = "numpy (int64 cents, exact)"
        out[path] = r
    # the frames path: 60M rows back to the host each run
    name = "tpcxbb_window_frames"
    q = tpcxbb.window_frames(tables)
    times = []
    for i in range(4):  # one cold run, 3 warm
        CB.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        batches = q.toLocalBatches()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        if i == 0:
            launches[name] = CB.launch_counts()
            assert_on_device(sess)
    warm = times[1:]
    cols = [np.concatenate([b.columns[j].data for b in batches])
            for j in range(4)]
    user, ts, run = cols[0], cols[1], cols[3]
    # rows of one (user, click time) share their running sum
    order = np.argsort(click_key(user, ts), kind="stable")
    check(np.array_equal(user[order], sorted_clicks[0]),
          f"{name}: rows differ from the clicks")
    check(np.array_equal(run[order], running),
          f"{name}: running sum differs from numpy")
    out[name] = {"cold_s": times[0], "warm_s": warm,
                 "warm_median_s": statistics.median(warm),
                 "rows": int(len(user)),
                 "input_rows": rows["web_clickstreams"],
                 "rows_per_s": rows["web_clickstreams"] /
                 statistics.median(warm),
                 "checked_against": "numpy (running sum), the CPU engine "
                                    "at small SF"}
    log(f"{name}: {len(user)} rows, cold {out[name]['cold_s']:.4f} s, "
        f"warm {warm}")
    del batches, cols, user, ts, run, sorted_clicks, running
    out["geomean_warm_s"] = geomean([out[f"tpcxbb_{q}"]["warm_median_s"]
                                     for q in tpcxbb.QUERIES])
    log(f"phase 7: geomean of the 30 warm medians "
        f"{out['geomean_warm_s']:.4f} s")
    out["device_bytes"] = torch.cuda.memory_allocated()
    if profile_dir:
        slow = sorted(tpcxbb.QUERIES, key=lambda q: -out[f"tpcxbb_{q}"][
            "warm_median_s"])[:2]
        for qn in ["q05_like"] + [s for s in slow if s != "q05_like"]:
            if qn == "q02_like":
                continue
            out[f"tpcxbb_{qn}"]["profile"] = profile_query(
                tpcxbb.QUERIES[qn](tables), profile_dir, f"tpcxbb_{qn}")
    # the Parquet v2 phase over the same SF 10 tables
    cached = {k: v.pop("result_rows") for k, v in out.items()
              if k.startswith("tpcxbb_") and "result_rows" in v}
    names = [q for q in sorted(tpcxbb.QUERIES) if q != "q02_like"]
    v2.update(run_parquet_v2_xbb(sess, raw, cached, rows, launches, names,
                                 V2_WARM_REPS, profile_dir=profile_dir))
    v2_samples = {"wcs_click_ts": table_columns(
        raw["web_clickstreams"], ("wcs_click_ts",))["wcs_click_ts"][
            :V2_ROW_GROUP].copy(),
        "ss_net_paid": table_columns(raw["store_sales"], ("ss_net_paid",))[
            "ss_net_paid"][:V2_ROW_GROUP].copy()}
    v2_s = [best_s(v2[k]) for k in v2 if k.startswith("parquet_v2_xbb_")]
    v2["geomean_s"] = geomean(v2_s)
    v2["geomean_of"] = "warm medians" if V2_WARM_REPS else "cold runs"
    v2["queries"] = len(v2_s)
    v2["cached_geomean_warm_s"] = out["geomean_warm_s"]
    log(f"parquet v2: geomean of the {len(v2_s)} {v2['geomean_of']} over "
        f"v2 Parquet {v2['geomean_s']:.4f} s (cached tables' warm medians "
        f"{out['geomean_warm_s']:.4f} s)")
    out["parquet_v2"] = v2
    del raw
    release(sess, tables)
    return out, pr_content, v2_samples


def run_xbb_small_sf() -> dict:
    """All 30 queries and the frames path at XBB_SMALL_SF on the card
    against the port's numpy CPU engine, rows in order (the frames path's
    as a set), DOUBLE within TPCH_REL."""
    import spark_rapids_tpu_torch as srt
    from spark_rapids_tpu_torch.benchmarks import tpcxbb

    card = srt.new_session(TPCH_CONF)
    host = srt.new_session({"rapids.tpu.sql.variableFloatAgg.enabled": True,
                            "rapids.tpu.sql.enabled": False}, device="cpu")
    tabs = []
    for sess in (card, host):
        sess.set_conf("rapids.tpu.sql.shuffle.partitions", XBB_SHUFFLE)
        tabs.append({k: v.cache() for k, v in tpcxbb.gen_tables(
            sess, sf=XBB_SMALL_SF, num_partitions=TPCXBB_PARTITIONS).items()})
    out = {"sf": XBB_SMALL_SF}
    queries = dict(tpcxbb.QUERIES, window_frames=tpcxbb.window_frames)
    for q, fn in queries.items():
        t = time.perf_counter()
        got = fn(tabs[0]).collect()
        card_s = time.perf_counter() - t
        assert_on_device(card)
        t = time.perf_counter()
        want = fn(tabs[1]).collect()
        host_s = time.perf_counter() - t
        if q == "window_frames":
            got, want = sorted(got), sorted(want)
        worst = check_rows(got, want, f"{q} at SF {XBB_SMALL_SF} vs the CPU "
                           "engine")
        out[q] = {"rows": len(got), "card_s": card_s, "cpu_engine_s": host_s,
                  "max_rel_diff": worst}
    log(f"phase 7: all 30 queries and the frames path at SF {XBB_SMALL_SF} "
        "equal the CPU engine: " + ", ".join(
            f"{q} {v['rows']}" for q, v in out.items() if q != "sf"))
    for d in tabs[0].values():
        d.unpersist()
    card.last_physical_plan = None
    return out


# ----------------------------------------------------- window kernels
def window_setup(part_cols, order_cols, orders, live):
    """K1's permutation and the words of a window sort (exec/window.py)."""
    from spark_rapids_tpu_torch.exec import rowkeys as RK
    from spark_rapids_tpu_torch.exec import window as W

    words, n_part = W._window_words([RK.key_proxy(c) for c in part_cols],
                                    [RK.key_proxy(c) for c in order_cols],
                                    orders, live)
    return words, n_part, RK.radix_sort_pairs(words)


def compare_window(part_cols, order_cols, orders, live, values, label: str,
                   errs: dict, frames) -> None:
    """K14, K15 and K16 against their plain versions on one input set, bit
    for bit. values: [(data, validity)] of several dtypes; frames:
    WindowFrames for K16 (a bounded RANGE one only with a range key)."""
    import torch

    from spark_rapids_tpu_torch.exec import window as W
    from spark_rapids_tpu_torch.exec.window import RANGE_KEY_TYPES

    words, n_part, perm = window_setup(part_cols, order_cols, orders, live)
    range_key = None
    if len(order_cols) == 1 and order_cols[0].dtype in RANGE_KEY_TYPES:
        oc = order_cols[0]
        range_key = (oc.data, oc.validity, not orders[0].ascending)
    seg = W.window_segments(words, perm, live, n_part, range_key)
    seg_p = W.window_segments_plain(words, perm, live, n_part, range_key)
    for f, g, w in zip(seg._fields, seg, seg_p):
        if w is None:
            continue
        check(bits_equal(g, w), f"{label}: K14 {f} differs")
        errs["window_segments"] = max(errs.get("window_segments", 0.0),
                                      max_abs_err(g.long(), w.long()))
    for kind, n in (("row_number", 0), ("rank", 0), ("dense_rank", 0),
                    ("ntile", 3), ("ntile", 1000)):
        got = W.window_rank_offset(seg, perm, kind, n=n)
        want = W.window_rank_offset_plain(seg_p, perm, kind, n=n)
        check(bits_equal(got[0], want[0]) and bits_equal(got[1], want[1]),
              f"{label}: K15 {kind} differs")
        errs["window_rank_offset"] = max(
            errs.get("window_rank_offset", 0.0), max_abs_err(got[0], want[0]))
    for data, valid in values:
        defaults = [None, 3_000_000_000] if data.dtype == torch.int64 else \
            [None, True] if data.dtype == torch.bool else [None, -7]
        for offset in (-1, 1, -3, 2, 0):
            for default in defaults:
                got = W.window_rank_offset(seg, perm, "shift", offset=offset,
                                           values=data, validity=valid,
                                           default=default)
                want = W.window_rank_offset_plain(
                    seg_p, perm, "shift", offset=offset, values=data,
                    validity=valid, default=default)
                check(bits_equal(got[0], want[0]) and
                      bits_equal(got[1], want[1]),
                      f"{label}: K15 shift {offset} {data.dtype} differs")
        if data.dtype == torch.bool:
            continue
        funcs = {"count": torch.int64, "min": data.dtype,
                 "max": data.dtype, "first": data.dtype,
                 "last": data.dtype}
        funcs["sum"] = torch.float64 if data.is_floating_point() else \
            torch.int64
        funcs["avg"] = torch.float64
        for frame in frames:
            for func, out_dt in funcs.items():
                got = W.window_frame_agg(seg, perm, func, frame, data, valid,
                                         out_dt)
                want = W.window_frame_agg_plain(seg_p, perm, func, frame,
                                                data, valid, out_dt)
                check(bits_equal(got[1], want[1]),
                      f"{label}: K16 {func} {frame} validity differs")
                check(bits_equal(got[0], want[0]),
                      f"{label}: K16 {func} {frame} {data.dtype} differs")
                errs["window_frame_agg"] = max(
                    errs.get("window_frame_agg", 0.0),
                    max_abs_err(got[0], want[0]))


def window_edge_cases(dev, errs: dict) -> int:
    """K14-K16 on the edge cases: an empty batch (all pads), one row, one
    partition (no partitionBy), all rows peers (no orderBy), NULL partition
    and order keys, NULLS FIRST and LAST, descending, NaN / -0.0 / inf
    order keys, a TIMESTAMP range key with NULLs under every frame shape
    (unbounded, running, ROWS offsets, bounded RANGE, an empty frame),
    lag / lead with an int64 default beyond int32, values of int32, int64,
    float32 (integer-valued, so prefix sums are exact), float64 with NaN
    for min / max, and bool."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.columnar.dtypes import DataType
    from spark_rapids_tpu_torch.ops.base import BoundReference, SortOrder
    from spark_rapids_tpu_torch.ops.values import ColV
    from spark_rapids_tpu_torch.ops.window import WindowFrame

    rng = np.random.default_rng(31)

    def t(x):
        return torch.as_tensor(x).to(dev)

    def col(dt, data, null_frac=0.0):
        n = len(data)
        return ColV(dt, t(data), t(rng.random(n) >= null_frac))

    def order(asc=True, nulls_first=None):
        return SortOrder(BoundReference(0, DataType.INT64), asc, nulls_first)

    frames = [WindowFrame("rows", None, None), WindowFrame("rows", None, 0),
              WindowFrame("rows", -3, 0), WindowFrame("rows", 0, None),
              WindowFrame("rows", -2, 2), WindowFrame("rows", 2, 1),
              WindowFrame("range", None, None),
              WindowFrame("range", None, 0), WindowFrame("range", 0, 0)]
    bounded = [WindowFrame("range", -5, 5), WindowFrame("range", None, 3),
               WindowFrame("range", 0, 10), WindowFrame("range", 5, 10),
               WindowFrame("range", -3_600_000_000, 0)]
    n_cases = 0
    for cap, n, null_frac in ((8, 0, 0.0), (8, 1, 0.0), (4096, 4000, 0.2),
                              (1 << 16, 60_000, 0.1)):
        live = t(np.arange(cap) < n)
        values = [
            (t(rng.integers(-50, 50, cap).astype(np.int32)),
             t(rng.random(cap) > null_frac)),
            (t(rng.integers(-2**40, 2**40, cap).astype(np.int64)),
             t(rng.random(cap) > null_frac)),
            (t(rng.integers(-100, 100, cap).astype(np.float32)),
             t(rng.random(cap) > null_frac)),
            (t(rng.choice(np.array([np.nan, -0.0, 0.0, 1.0, -2.0, np.inf]),
                          cap)), t(rng.random(cap) > null_frac)),
            (t(rng.random(cap) > 0.5), t(rng.random(cap) > null_frac))]
        part = col(DataType.INT64, rng.integers(0, 9, cap).astype(np.int64),
                   null_frac)
        ts = col(DataType.TIMESTAMP, rng.integers(
            -3 * 3_600_000_000, 3 * 3_600_000_000, cap).astype(np.int64) //
            1000 * 1000, null_frac)
        ties = col(DataType.INT32, rng.integers(0, 7, cap).astype(np.int32),
                   null_frac)
        flt = col(DataType.FLOAT64, rng.choice(np.array(
            [np.nan, -0.0, 0.0, np.inf, -np.inf, 1.5]), cap), null_frac)
        for label, pcols, ocols, orders, fr in (
                ("ts asc", [part], [ts], [order()], frames + bounded),
                ("ts desc nulls first", [part], [ts], [order(False, True)],
                 frames + bounded),
                ("ts asc nulls last", [part], [ts], [order(True, False)],
                 frames + bounded),
                ("one partition", [], [ties], [order()], frames + bounded),
                ("all peers", [part], [], [], frames),
                ("float keys", [part], [flt, ties],
                 [order(False), order()], frames)):
            compare_window(pcols, ocols, orders, live, values,
                           f"K14-K16 {label} C={cap} n={n}", errs, fr)
            n_cases += 1
    return n_cases


def string_chars_edge_cases(dev, errs: dict) -> int:
    """K17 against its plain version: invalid UTF-8 (continuation bytes
    first, a lone lead byte), empty and NULL rows, multi-byte characters,
    a match at a row's end and one that would cross rows; start 0, 1,
    inside and beyond the length, -1; the empty needle, a needle longer
    than shared memory."""
    import numpy as np

    from spark_rapids_tpu_torch.columnar import strings as S

    rows = [b"", b"a", b"brandx", b"the brandx box", b"xbrandx", b"brand",
            b"x", b"\xc3\xa9brandx \xe2\x98\x83 brandx", b"\x80\x80brandx",
            b"\xc3", b"brandxbrandx", b"aab", b"aaab", b"ab", b"bra",
            b"ndx brandx", b"\xff\xfe", b"x" * 300 + b"brandx"]
    rng = np.random.default_rng(41)
    alphabet = [b"a", b"b", b"x", b" ", b"\xc3\xa9", b"\x80", b"brandx"]
    many = [b"".join(alphabet[int(i)] for i in rng.integers(
        0, len(alphabet), int(rng.integers(0, 12)))) for _ in range(20_000)]
    n = 0
    for case in (rows, many, [b""] * 5):
        offsets, raw, _ = raw_string_column(case, dev)
        got = S.utf8_char_lengths(offsets, raw)
        want = S.utf8_char_lengths_plain(offsets, raw)
        check(bits_equal(got, want), f"K17 lengths {n} differ")
        errs["string_chars"] = max(errs.get("string_chars", 0.0),
                                   max_abs_err(got, want))
        needles = [b"brandx", b"a", b"ab", b"x", b"", "é".encode(),
                   b"\x80", b"aab", b"zzz"]
        if n == 0:
            needles.append(b"q" * 20_000)  # past the shared-memory copy
        for needle in needles:
            for start in ((0, 1, 2, 3, 7, 40, -1) if len(needle) < 99
                          else (1, 2)):
                got = S.locate(offsets, raw, needle, start)
                want = S.locate_plain(offsets, raw, needle, start)
                check(bits_equal(got, want),
                      f"K17 locate {needle[:8]!r} {start} {n} differs")
                errs["string_chars"] = max(errs["string_chars"],
                                           max_abs_err(got, want))
        n += 1
    return n


def q05_window_batch(dev):
    """One window batch of q05 at SF 10: 60M clicks over 8 shuffle
    partitions is 7.5M rows, 1M users (about 125,000 a partition with 60
    clicks each), click times over 2003, item keys below 180,000."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.columnar.batch import bucket_capacity
    from spark_rapids_tpu_torch.columnar.dtypes import DataType
    from spark_rapids_tpu_torch.ops.values import ColV

    n = 60_000_000 // XBB_SHUFFLE
    cap = bucket_capacity(n)
    rng = np.random.default_rng(51)
    live = torch.arange(cap, device=dev) < n

    def t(x):
        pad = np.zeros(cap, dtype=x.dtype)
        pad[:n] = x
        return torch.from_numpy(pad).to(dev)

    user = t(rng.integers(0, 125_000, n) * 8)
    ts = t(rng.integers(1041379200, 1072915199, n) * 1_000_000)
    item = t(rng.integers(0, 180_000, n))
    return n, cap, live, ColV(DataType.INT64, user, live), \
        ColV(DataType.TIMESTAMP, ts, live), item


def time_window_kernels(dev, errs: dict, pr_content) -> dict:
    """K14-K16 at q05's window batch (7.5M rows, partition by user, order
    by click time), as q05 and the frames path call them: K14 with the
    TIMESTAMP range key; K15 as q05's lag of the click time; K16 as the
    frames path's running sum (reported), ROWS 3 PRECEDING max and hour
    RANGE count. K17 over product_reviews' pr_content at SF 10 (600,000
    rows of the generator's text, phase 7's column): lengths (reported)
    and locate('brandx'). Bounds: each input read once, each output written
    once."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.columnar import strings as S
    from spark_rapids_tpu_torch.exec import window as W
    from spark_rapids_tpu_torch.ops.base import BoundReference, SortOrder
    from spark_rapids_tpu_torch.ops.window import WindowFrame
    from spark_rapids_tpu_torch.columnar.dtypes import DataType

    iters, plain_iters = KERNEL_ITERS, PLAIN_ITERS
    n, cap, live, user, ts, item = q05_window_batch(dev)
    orders = [SortOrder(BoundReference(0, DataType.TIMESTAMP), True)]
    words, n_part, perm = window_setup([user], [ts], orders, live)
    rk = (ts.data, ts.validity, False)
    n_words = int(words.shape[0])
    rows = {}
    seg = W.window_segments(words, perm, live, n_part, rk)
    seg_p = W.window_segments_plain(words, perm, live, n_part, rk)
    for f, g, w in zip(seg._fields, seg, seg_p):
        check(bits_equal(g, w), f"K14 q05 batch: {f} differs")
    rows["window_segments"] = dict(
        ms=cuda_ms(lambda: W.window_segments(words, perm, live, n_part, rk),
                   iters),
        plain_ms=cuda_ms(lambda: W.window_segments_plain(
            words, perm, live, n_part, rk), plain_iters),
        library_ms=None,
        # in: the words, perm, live, the range key and its validity; out:
        # live_s, six int32 (pgid, start, end, peer_start, peer_end,
        # peer_id), key_s, kvalid, nn_start, nn_end
        bound_ms=bound_ms((4 * n_words + 4 + 1 + 8 + 1) * cap +
                          (1 + 6 * 4 + 8 + 1 + 4 + 4) * cap),
        shape=f"{n} rows (cap {cap}), {n_words} key words, TIMESTAMP "
              "range key")
    got = W.window_rank_offset(seg, perm, "shift", offset=-1,
                               values=ts.data, validity=ts.validity)
    want = W.window_rank_offset_plain(seg, perm, "shift", offset=-1,
                                      values=ts.data, validity=ts.validity)
    check(bits_equal(got[0], want[0]) and bits_equal(got[1], want[1]),
          "K15 q05 batch: lag differs")
    rows["window_rank_offset"] = dict(
        ms=cuda_ms(lambda: W.window_rank_offset(
            seg, perm, "shift", offset=-1, values=ts.data,
            validity=ts.validity), iters),
        plain_ms=cuda_ms(lambda: W.window_rank_offset_plain(
            seg, perm, "shift", offset=-1, values=ts.data,
            validity=ts.validity), plain_iters),
        library_ms=None,
        # in: perm, live_s, start, the values and their validity (a lag's
        # source row is never past its partition's end); out: 8 + 1
        bound_ms=bound_ms((4 + 1 + 4 + 8 + 1) * cap + 9 * cap),
        shape=f"{n} rows, lag(click_ts, 1)")
    ones = torch.ones(cap, dtype=torch.bool, device=dev)
    # the bytes a row of each array holds, and the arrays each run needs:
    # a running RANGE frame is [start, peer_end]; ROWS -3..0 ends at the
    # row itself; the hour RANGE count reads no values, searches its lower
    # bound in [nn_start, row] and ends at peer_end (no click time is NULL)
    width = dict(perm=4, value=8, flag=1, live=1, start=4, peer_end=4,
                 key_s=8, kvalid=1, nn_start=4)
    runs = (("ms", "sum", WindowFrame("range", None, 0),
             ("perm", "value", "flag", "live", "start", "peer_end")),
            ("ms_max_rows", "max", WindowFrame("rows", -3, 0),
             ("perm", "value", "flag", "live", "start")),
            ("ms_count_range", "count",
             WindowFrame("range", -3_600_000_000, 0),
             ("perm", "flag", "live", "key_s", "kvalid", "nn_start",
              "peer_end")))
    r = {}
    for key, func, frame, arrays in runs:
        in_bytes = sum(width[a] for a in arrays)
        out_dt = torch.int64
        got = W.window_frame_agg(seg, perm, func, frame, item, ones, out_dt)
        want = W.window_frame_agg_plain(seg, perm, func, frame, item, ones,
                                        out_dt)
        check(bits_equal(got[0], want[0]) and bits_equal(got[1], want[1]),
              f"K16 q05 batch: {func} differs")
        r[key] = cuda_ms(lambda: W.window_frame_agg(
            seg, perm, func, frame, item, ones, out_dt), iters)
        r["bound_" + key] = bound_ms((in_bytes + 9) * cap)
        if key == "ms":
            r["plain_ms"] = cuda_ms(lambda: W.window_frame_agg_plain(
                seg, perm, func, frame, item, ones, out_dt), plain_iters)
    r["library_ms"] = None
    r["shape"] = (f"{n} rows, sum(item) RANGE UNBOUNDED PRECEDING .. "
                  "CURRENT ROW")
    rows["window_frame_agg"] = r
    del seg, seg_p, words, perm, user, ts, item, live

    offs, raw = pr_content.utf8()
    offsets = torch.from_numpy(offs.astype(np.int32)).to(dev)
    data = torch.from_numpy(raw.copy()).to(dev)
    nrows, nbytes = len(offs) - 1, int(offs[-1])
    got = S.utf8_char_lengths(offsets, data)
    check(bits_equal(got, S.utf8_char_lengths_plain(offsets, data)),
          "K17 pr_content lengths differ")
    loc = S.locate(offsets, data, b"brandx", 1)
    check(bits_equal(loc, S.locate_plain(offsets, data, b"brandx", 1)),
          "K17 pr_content locate differs")
    found = loc.cpu().numpy()
    # locate reads a row to the end of its first match (all of it without)
    need = np.where(found > 0, found - 1 + 6,
                    np.diff(offs)).sum()
    rows["string_chars"] = dict(
        ms=cuda_ms(lambda: S.utf8_char_lengths(offsets, data), iters),
        plain_ms=cuda_ms(lambda: S.utf8_char_lengths_plain(offsets, data),
                         plain_iters),
        library_ms=None,
        bound_ms=bound_ms(4 * (nrows + 1) + nbytes + 4 * nrows),
        ms_locate=cuda_ms(lambda: S.locate(offsets, data, b"brandx", 1),
                          iters),
        bound_ms_locate=bound_ms(4 * (nrows + 1) + int(need) + 4 * nrows),
        shape=f"{nrows} rows like pr_content ({nbytes} bytes), lengths")
    return rows


# ----------------------------------------------------------- kernels
def max_abs_err(a, b) -> float:
    import torch

    if a.dtype.is_floating_point:
        ok = torch.isnan(a) == torch.isnan(b)
        check(bool(ok.all()), "NaN positions differ")
        mask = ~torch.isnan(a)
        if not bool(mask.any()):
            return 0.0
        return float((a[mask].double() - b[mask].double()).abs().max())
    return float((a.long() - b.long()).abs().max()) if a.numel() else 0.0


def bits_equal(a, b) -> bool:
    """Exact equality, NaN == NaN: floats compare by bit pattern (both
    sides emit the canonical NaN)."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    if a.dtype == torch.float64:
        return torch.equal(a.view(torch.int64), b.view(torch.int64))
    return torch.equal(a, b)


def rel_ok(a, b, rel: float) -> bool:
    import torch

    a, b = a.double(), b.double()
    nan = torch.isnan(a)
    if not torch.equal(nan, torch.isnan(b)):
        return False
    a, b = a[~nan], b[~nan]
    return bool(torch.all((a - b).abs() <= rel * torch.maximum(
        a.abs(), b.abs()) + 1e-300))


def compare_pipeline(key_cols, live, specs, n_parts: int, label: str,
                     errs: dict) -> None:
    """Every kernel against its plain version on one input set."""
    import torch

    from spark_rapids_tpu_torch.exec import rowkeys as RK
    from spark_rapids_tpu_torch.ops import hashing as H
    from spark_rapids_tpu_torch.shuffle import exchange as X

    cap = live.shape[0]
    words = RK.sort_words([RK.key_proxy(c) for c in key_cols], live)
    order = RK.radix_sort_pairs(words)
    order_p = RK.radix_sort_pairs_plain(words)
    check(torch.equal(order, order_p), f"{label}: K1 order differs")
    errs["radix_sort_pairs"] = max(errs.get("radix_sort_pairs", 0.0),
                                   max_abs_err(order, order_p))
    got = RK.group_ids(words, order, live)
    want = RK.group_ids_plain(words, order_p, live)
    for g, w, name in zip(got, want, ("gid", "gid_sorted", "rep_rows",
                                      "seg_ends", "num_groups")):
        check(torch.equal(g, w), f"{label}: K2 {name} differs")
        errs["group_ids"] = max(errs.get("group_ids", 0.0),
                                max_abs_err(g, w))
    gi = RK.GroupInfo(got[0], got[4], got[2], order, got[1], got[3])
    outs = RK.segment_reduce_many(specs, gi, cap)
    for (op, data, valid), (o, ov) in zip(specs, outs):
        po, pov = RK.segment_reduce_plain(op, data, valid, gi, cap)
        check(torch.equal(ov, pov), f"{label}: K3 {op} validity differs")
        if op == "sum" and o.dtype.is_floating_point:
            rel = 1e-5 if o.dtype == torch.float32 else 1e-12
            check(rel_ok(o, po, rel), f"{label}: K3 float sum off")
        else:
            check(bits_equal(o, po), f"{label}: K3 {op} differs")
        errs["segment_reduce"] = max(errs.get("segment_reduce", 0.0),
                                     max_abs_err(o, po))
    ids, counts = H.partition_ids(key_cols, live, n_parts)
    ids_p, counts_p = H.partition_ids_plain(key_cols, live, n_parts)
    check(torch.equal(ids, ids_p) and torch.equal(counts, counts_p),
          f"{label}: K4 hash differs")
    errs["hash_partition"] = max(errs.get("hash_partition", 0.0),
                                 max_abs_err(ids, ids_p))
    ro, rc = X.route_plan(ids, n_parts)
    ro_p, rc_p = X.route_plan_plain(ids, n_parts)
    check(torch.equal(ro, ro_p) and torch.equal(rc, rc_p),
          f"{label}: K4 route differs")
    errs["route_plan"] = max(errs.get("route_plan", 0.0),
                             max_abs_err(ro, ro_p))


def edge_cases(dev, errs: dict) -> int:
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.columnar.dtypes import DataType
    from spark_rapids_tpu_torch.ops.values import ColV

    rng = np.random.default_rng(7)
    n_cases = 0

    def t(x):
        return torch.as_tensor(x).to(dev)

    def specs_for(cap, nulls):
        v = t(rng.random(cap) >= nulls)
        i64 = t(rng.integers(-2**62, 2**62, cap).astype(np.int64))
        f32 = t(rng.standard_normal(cap).astype(np.float32))
        f64 = t(rng.standard_normal(cap))
        f32[::7] = float("nan")
        return [("sum", i64, v), ("count", i64, v), ("min", i64, v),
                ("max", i64, v), ("sum", f32, v), ("min", f32, v),
                ("max", f32, v), ("sum", f64, v), ("max", f64, v),
                ("min", t(rng.integers(-50, 50, cap).astype(np.int32)), v)]

    for cap in (8, 4096, 1 << 17):
        for nulls in (0.0, 0.3):
            k = t(rng.integers(0, 37, cap).astype(np.int64))
            kv = t(rng.random(cap) >= nulls)
            live = t(np.arange(cap) < cap - 3)
            compare_pipeline([ColV(DataType.INT64, k, kv)], live,
                             specs_for(cap, nulls), 8, f"int64 C={cap}",
                             errs)
            n_cases += 1
    cap = 4096
    # all pads
    k = t(rng.integers(0, 5, cap).astype(np.int64))
    ones = t(np.ones(cap, dtype=bool))
    compare_pipeline([ColV(DataType.INT64, k, ones)],
                     t(np.zeros(cap, dtype=bool)), specs_for(cap, 0.0), 8,
                     "all pads", errs)
    # one group, with int64 sums that wrap
    big = t(np.full(cap, 2**62 + 12345, dtype=np.int64))
    compare_pipeline([ColV(DataType.INT64, t(np.zeros(cap, np.int64)),
                           ones)], ones,
                     [("sum", big, ones), ("count", big, ones),
                      ("max", big, ones)], 8, "one group + wrap", errs)
    # NaN / -0.0 / inf float keys, two key columns, nulls
    f = rng.choice(np.array([np.nan, -0.0, 0.0, np.inf, -np.inf, 1.5,
                             -2.25], dtype=np.float64), cap)
    fk32 = ColV(DataType.FLOAT32, t(f.astype(np.float32)),
                t(rng.random(cap) > 0.1))
    fk64 = ColV(DataType.FLOAT64, t(f[::-1].copy()), ones)
    ik = ColV(DataType.INT32, t(rng.integers(-3, 3, cap).astype(np.int32)),
              t(rng.random(cap) > 0.2))
    compare_pipeline([fk32, fk64, ik], ones, specs_for(cap, 0.2), 8,
                     "float keys", errs)
    return n_cases + 3


def string_column(values, dev):
    """(offsets, bytes, validity) on the card of a list of str / None."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.columnar.strings import encode_utf8

    valid = np.array([v is not None for v in values], dtype=bool)
    data = np.array([v if v is not None else "" for v in values],
                    dtype=object)
    offsets, raw = encode_utf8(data, valid)
    raw = np.concatenate([raw, np.zeros(8, np.uint8)])
    return (torch.from_numpy(offsets).to(dev), torch.from_numpy(raw).to(dev),
            torch.from_numpy(valid).to(dev))


def pool_column(pool, n: int, seed: int, dev):
    """n rows drawn from a pool of values, on the card."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.columnar.strings import encode_pool

    codes = np.random.default_rng(seed).integers(0, len(pool), n)
    _, offsets, raw = encode_pool(pool, codes)
    return (torch.from_numpy(offsets).to(dev), torch.from_numpy(raw).to(dev),
            torch.ones(n, dtype=torch.bool, device=dev))


def compare_strings(col, chunk_words: int, label: str, errs: dict,
                    seed: int = 0) -> None:
    """K5, K6 and K7 against their plain versions on one string column:
    words, offsets, validity and bytes bit for bit."""
    import torch

    from spark_rapids_tpu_torch.columnar import batch as CBT
    from spark_rapids_tpu_torch.exec import rowkeys as RK
    from spark_rapids_tpu_torch.ops import hashing as H

    offsets, raw, valid = col
    n = int(valid.shape[0])
    got = H.string_hash_words(offsets, raw, valid)
    want = H.string_hash_words_plain(offsets, raw, valid)
    check(torch.equal(got, want), f"{label}: K5 words differ")
    errs["string_hash_words"] = max(errs.get("string_hash_words", 0.0),
                                    max_abs_err(got, want))
    got = RK.string_order_words(offsets, raw, valid, chunk_words)
    want = RK.string_order_words_plain(offsets, raw, valid, chunk_words)
    check(torch.equal(got, want), f"{label}: K6 words differ")
    errs["string_order_words"] = max(errs.get("string_order_words", 0.0),
                                     max_abs_err(got, want))
    gen = torch.Generator(device=offsets.device).manual_seed(seed)
    perm = torch.randperm(n, generator=gen, device=offsets.device).to(
        torch.int32)
    byte_cap = CBT.bucket_capacity(max(int(offsets[-1]), 1))
    for idx, rows in ((perm, n), (perm[: max(n // 2, 1)], n // 2)):
        new_off, data, ok = CBT.gather_strings(offsets, raw, valid, idx,
                                               rows, None, byte_cap)
        total = int(new_off[-1])
        want_off, want_ok = CBT.gather_strings_plan_plain(
            offsets, valid, idx, rows)
        want_data = CBT.gather_strings_copy_plain(offsets, raw, idx,
                                                  want_off, max(total, 1))
        check(torch.equal(new_off, want_off) and torch.equal(ok, want_ok),
              f"{label}: K7 offsets or validity differ")
        check(torch.equal(data[:total], want_data[:total]),
              f"{label}: K7 bytes differ")
        errs["gather_strings"] = max(
            errs.get("gather_strings", 0.0),
            max_abs_err(new_off, want_off),
            max_abs_err(data[:total], want_data[:total]))


STRING_EDGES = ["", None, "a", "ab", "abc", "abcd", "abcde", "abcdefgh",
                "abcdefghi", "héllo wörld", "日本語テキスト", "☃" * 30,
                "x" * 64, "y" * 300, "ab", "abcÿ", None, "TAKE BACK RETURN"]


def string_edge_cases(dev, errs: dict) -> int:
    from spark_rapids_tpu_torch.exec import rowkeys as RK
    from spark_rapids_tpu_torch.columnar.strings import len_bucket

    n = 0
    for values in (STRING_EDGES, [None] * 9, [""] * 5,
                   STRING_EDGES * 700):
        lens = [len(v.encode()) for v in values if v is not None] or [1]
        words = RK.string_chunk_words(
            SimpleNamespace(max_len=len_bucket(max(lens))))
        compare_strings(string_column(values, dev), words, f"strings {n}",
                        errs, n)
        n += 1
    return n


def time_string_kernels(dev, errs: dict) -> dict:
    """K5 and K6 over 2^25 rows shaped like l_shipmode (max_len 7, two
    chunk words) and like l_shipinstruct (max_len 17, eight chunk words:
    four uint64 chunks); K7 gathers the l_shipinstruct rows through a random
    permutation. Times are the l_shipinstruct shape."""
    import torch

    from spark_rapids_tpu_torch.benchmarks import tpch
    from spark_rapids_tpu_torch.columnar import batch as CBT
    from spark_rapids_tpu_torch.exec import rowkeys as RK
    from spark_rapids_tpu_torch.ops import hashing as H

    n = 1 << 25
    rows = {}
    iters, plain_iters = KERNEL_ITERS, PLAIN_ITERS
    for label, pool, words in (("l_shipmode", tpch._SHIPMODES, 2),
                               ("l_shipinstruct", tpch._INSTRUCT, 8)):
        col = pool_column(pool, n, 5, dev)
        compare_strings(col, words, f"{label} 2^25", errs)
    offsets, raw, valid = col
    total = int(offsets[-1])
    base = 4 * (n + 1) + n + total  # offsets, validity, bytes read once
    rows["string_hash_words"] = dict(
        ms=cuda_ms(lambda: H.string_hash_words(offsets, raw, valid), iters),
        plain_ms=cuda_ms(lambda: H.string_hash_words_plain(
            offsets, raw, valid), plain_iters),
        library_ms=None, bound_ms=bound_ms(base + 12 * n),
        shape=f"{n} rows like l_shipinstruct, {total} bytes")
    rows["string_order_words"] = dict(
        ms=cuda_ms(lambda: RK.string_order_words(offsets, raw, valid, 8),
                   iters),
        plain_ms=cuda_ms(lambda: RK.string_order_words_plain(
            offsets, raw, valid, 8), plain_iters),
        library_ms=None, bound_ms=bound_ms(base + 4 * 9 * n),
        shape=f"{n} rows like l_shipinstruct, 8 chunk words + length")
    perm = torch.randperm(n, device=dev).to(torch.int32)
    byte_cap = CBT.bucket_capacity(total)

    def plain_k7():
        off, ok = CBT.gather_strings_plan_plain(offsets, valid, perm, n)
        return CBT.gather_strings_copy_plain(offsets, raw, perm, off,
                                             byte_cap)

    rows["gather_strings"] = dict(
        ms=cuda_ms(lambda: CBT.gather_strings(offsets, raw, valid, perm, n,
                                              None, byte_cap), iters),
        plain_ms=cuda_ms(plain_k7, plain_iters),
        library_ms=None,
        bound_ms=bound_ms(4 * n + base + 4 * (n + 1) + n + total),
        shape=f"{n} rows like l_shipinstruct through a permutation")
    return rows


# ------------------------------------------------- K8-K11 (slice 3)
CMP_OPS = ("eq", "lt", "le", "gt", "ge")
CMP_LITERALS = ("", "ab", "abcdefghi", "BUILDING", "a\x00", "é", None)


def column_view(col):
    """A string column (offsets, bytes, validity) as a K8 view."""
    from spark_rapids_tpu_torch.columnar.strings import StrView

    offsets, raw, valid = col
    return StrView(raw, offsets[:-1], offsets[1:] - offsets[:-1], valid)


def literal_view(value, n: int, dev):
    from spark_rapids_tpu_torch.columnar.dtypes import DataType
    from spark_rapids_tpu_torch.columnar.strings import as_view
    from spark_rapids_tpu_torch.ops.values import ScalarV

    return as_view(SimpleNamespace(capacity=n, device=dev),
                   ScalarV(DataType.STRING, value))


def permuted_view(view, perm):
    from spark_rapids_tpu_torch.columnar.strings import StrView

    return StrView(view.data, view.starts[perm].contiguous(),
                   view.lens[perm].contiguous(),
                   view.validity[perm].contiguous())


def compare_k8(left, right, label: str, errs: dict) -> None:
    import torch

    from spark_rapids_tpu_torch.columnar import strings as S

    for op in CMP_OPS:
        got = S.string_compare_views(left, right, op)
        want = S.string_compare_plain(left, right, op)
        check(torch.equal(got, want), f"{label}: K8 {op} differs")
        errs["string_compare"] = max(errs.get("string_compare", 0.0),
                                     max_abs_err(got.int(), want.int()))


def join_inputs(n_build: int, n_stream: int, key_hi: int, seed: int,
                dev, skew: float = 0.0, nulls: float = 0.0):
    """Int64 join keys as K9-K11 see them: (build words, build ok, stream
    words, stream live, stream ok). Stream keys are drawn from twice the
    build's key range, so about half of them are present."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.columnar.dtypes import DataType
    from spark_rapids_tpu_torch.exec import join as J
    from spark_rapids_tpu_torch.ops.values import ColV

    rng = np.random.default_rng(seed)
    bk = rng.integers(0, key_hi, n_build)
    sk = rng.integers(0, 2 * key_hi, n_stream)
    if skew:
        sk[rng.random(n_stream) < skew] = 7
    sides = []
    for keys, n in ((bk, n_build), (sk, n_stream)):
        valid = torch.from_numpy(rng.random(n) >= nulls).to(dev)
        live = torch.arange(n, device=dev) < n - (3 if n > 8 else 0)
        col = ColV(DataType.INT64, torch.from_numpy(keys).to(dev), valid)
        sides.append((*J.join_words([col], live), live))
    (bw, b_ok, _), (sw, s_ok, s_live) = sides
    return bw, b_ok, sw, s_live, s_ok


def compare_join(inputs, mode: str, label: str, errs: dict):
    """K9-K11 against the plain union plan: offsets, stream and build
    indices and build-matched flags bit for bit. Returns the probe."""
    import torch

    from spark_rapids_tpu_torch.columnar.batch import bucket_capacity
    from spark_rapids_tpu_torch.exec import join as J

    bw, b_ok, sw, s_live, s_ok = inputs
    table = J.join_build(bw, b_ok)
    probe = J.join_probe(table, sw, s_live, s_ok, mode)
    out_cap = bucket_capacity(max(probe.total, 1))
    s_idx, b_idx = J.join_expand(probe, out_cap)
    offsets, total, b_order, start, match_cnt, b_matched = \
        J.join_plan_plain(sw, s_live, s_ok, bw, b_ok, mode)
    ps, pb = J.join_expand_plain(offsets, match_cnt, start, b_order,
                                 out_cap)
    check(total == probe.total, f"{label}: K10 total {probe.total} vs "
          f"plain {total}")
    check(torch.equal(offsets, probe.offsets), f"{label}: K10 offsets differ")
    check(torch.equal(s_idx, ps) and torch.equal(b_idx, pb),
          f"{label}: K11 indices differ")
    got_m = J.build_matched(table)
    check(torch.equal(got_m, b_matched), f"{label}: K10 matched differ")
    for name, err in (("join_build", max_abs_err(got_m.int(),
                                                   b_matched.int())),
                      ("join_probe", max_abs_err(offsets, probe.offsets)),
                      ("join_expand", max(max_abs_err(s_idx, ps),
                                          max_abs_err(b_idx, pb)))):
        errs[name] = max(errs.get(name, 0.0), err)
    return table, probe


def join_edge_cases(dev, errs: dict) -> int:
    """K8 on edge strings against literals and a reversed column; K9-K11
    in every join mode on small, NULL-keyed, empty-matched and skewed
    inputs."""
    import torch

    n = 0
    for values in (STRING_EDGES + ["a\x00", "ÿ", "abcdefghij1",
                                   "abcdefghij2"], [None] * 9, [""] * 5,
                   STRING_EDGES * 700):
        view = column_view(string_column(values, dev))
        rows = len(values)
        for lit in CMP_LITERALS:
            compare_k8(view, literal_view(lit, rows, dev), f"K8 {n} {lit!r}",
                       errs)
        rev = torch.arange(rows - 1, -1, -1, device=dev)
        compare_k8(view, permuted_view(view, rev), f"K8 {n} reversed", errs)
        n += 1
    for mode in ("inner", "outer", "semi", "anti"):
        for nb, ns, hi, nulls in ((8, 8, 3, 0.0), (8, 4096, 2, 0.3),
                                  (5000, 3000, 40, 0.1),
                                  (1 << 16, 1 << 17, 1 << 14, 0.05)):
            compare_join(join_inputs(nb, ns, hi, n, dev, nulls=nulls), mode,
                         f"join {mode} {nb}x{ns}", errs)
            n += 1
    compare_join(join_inputs(1 << 18, 1 << 18, 1 << 16, 99, dev, skew=0.01),
                 "outer", "join skewed", errs)
    return n + 1


def time_join_kernels(dev, errs: dict) -> dict:
    """K8 at 2^25 rows shaped like c_mktsegment, against the literal
    'BUILDING' and against a permutation of itself (op '='); K9-K11 at the
    shape of q5's s_suppkey = l_suppkey: 2^23 build rows with keys in
    [0, 2^21) (4 rows a key), 2^22 stream rows with half their keys
    present; and a skewed stream (1% of its rows on one key)."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.benchmarks import tpch
    from spark_rapids_tpu_torch.columnar import strings as S
    from spark_rapids_tpu_torch.columnar.batch import bucket_capacity
    from spark_rapids_tpu_torch.columnar.strings import encode_pool
    from spark_rapids_tpu_torch.exec import join as J

    rows = {}
    iters, plain_iters = KERNEL_ITERS, PLAIN_ITERS
    n = K8_ROWS
    pool = tpch._SEGMENTS
    rng = np.random.default_rng(11)
    codes = rng.integers(0, len(pool), n)
    _, offsets, raw = encode_pool(pool, codes)
    col = (torch.from_numpy(offsets).to(dev), torch.from_numpy(raw).to(dev),
           torch.ones(n, dtype=torch.bool, device=dev))
    view = column_view(col)
    lit = literal_view("BUILDING", n, dev)
    perm_np = rng.permutation(n)
    perm = torch.from_numpy(perm_np).to(dev)
    other = permuted_view(view, perm)
    compare_k8(view, lit, "K8 c_mktsegment vs 'BUILDING'", errs)
    compare_k8(view, other, "K8 c_mktsegment vs its permutation", errs)

    def needed(a: str, b: str) -> int:
        """Bytes of one side an equality compare must read."""
        a, b = a.encode(), b.encode()
        if len(a) != len(b):
            return 0
        diff = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
        return diff[0] + 1 if diff else len(a)

    counts = np.bincount(codes, minlength=len(pool))
    lit_bytes = sum(int(counts[i]) * needed(v, "BUILDING")
                    for i, v in enumerate(pool))
    pair = np.array([[needed(a, b) for b in pool] for a in pool])
    col_bytes = 2 * int(pair[codes, codes[perm_np]].sum())
    per_side = 4 * (n + 1) + n  # offsets and validity
    rows["string_compare"] = dict(
        ms=cuda_ms(lambda: S.string_compare_views(view, lit, "eq"), iters),
        plain_ms=cuda_ms(lambda: S.string_compare_plain(view, lit, "eq"),
                         plain_iters),
        library_ms=None, bound_ms=bound_ms(per_side + lit_bytes + n),
        ms_column=cuda_ms(lambda: S.string_compare_views(view, other, "eq"),
                          iters),
        bound_ms_column=bound_ms(2 * per_side + col_bytes + n),
        shape=f"{n} rows like c_mktsegment = 'BUILDING' ({lit_bytes} "
              f"string bytes needed); against a permutation of itself: "
              f"see ms_column")
    del col, view, lit, other, perm

    n_build, n_stream, key_hi = JOIN_SHAPE
    inputs = join_inputs(n_build, n_stream, key_hi, 5, dev)
    table, probe = compare_join(inputs, "inner", "join q5 shape", errs)
    skewed = join_inputs(n_build, n_stream, key_hi, 6, dev, skew=0.01)
    compare_join(skewed, "inner", "join q5 shape, skewed", errs)
    bw, b_ok, sw, s_live, s_ok = inputs
    out_cap = bucket_capacity(max(probe.total, 1))
    distinct = int(torch.unique(bw[:, b_ok], dim=1).shape[1])
    found = int((probe.match_cnt > 0).sum())

    def plain_plan():
        return J.join_plan_plain(sw, s_live, s_ok, bw, b_ok, "inner")

    plan = plain_plan()
    plain_plan_ms = cuda_ms(plain_plan, plain_iters)
    rows["join_build"] = dict(
        ms=cuda_ms(lambda: J.join_build(bw, b_ok), iters),
        plain_ms=plain_plan_ms, library_ms=None,
        bound_ms=bound_ms(n_build * (8 + 1 + 4 + 4) + 8 * distinct),
        shape=f"{n_build} build rows, {distinct} keys (K1 over the slots "
              "included); plain: the union plan, which also probes")
    rows["join_probe"] = dict(
        ms=cuda_ms(lambda: J.join_probe(table, sw, s_live, s_ok, "inner"),
                   iters),
        plain_ms=plain_plan_ms, library_ms=None,
        bound_ms=bound_ms(n_stream * (10 + 4 + 12) + found * 16),
        shape=f"{n_stream} stream rows, {found} with a match, "
              f"{probe.total} output rows; plain: the union plan")
    # one call gives the expansion's stream side: each stream row repeated
    # by its match count
    match_cnt = plan[4].long()
    rows["join_expand"] = dict(
        ms=cuda_ms(lambda: J.join_expand(probe, out_cap), iters),
        plain_ms=cuda_ms(lambda: J.join_expand_plain(
            plan[0], plan[4], plan[3], plan[2], out_cap), plain_iters),
        library_ms=cuda_ms(lambda: torch.repeat_interleave(
            match_cnt, output_size=probe.total), plain_iters),
        bound_ms=bound_ms(12 * n_stream + 4 + 4 * probe.total +
                          8 * out_cap),
        shape=f"{probe.total} output rows in {out_cap} lanes")
    sk_table = J.join_build(skewed[0], skewed[1])
    sk_probe = J.join_probe(sk_table, skewed[2], skewed[3], skewed[4],
                            "inner")
    sk_cap = bucket_capacity(max(sk_probe.total, 1))
    rows["join_expand"]["ms_skewed"] = cuda_ms(
        lambda: J.join_expand(sk_probe, sk_cap), iters)
    rows["join_probe"]["ms_skewed"] = cuda_ms(
        lambda: J.join_probe(sk_table, skewed[2], skewed[3], skewed[4],
                             "inner"), iters)
    return rows


# ------------------------------------------------- K12-K13 (slice 4)
SEARCH_EDGES = ["", None, "a", "ab", "aab", "aaab", "xa", "ab", "bx",
                "a\x00b", "\x00", "ÿab", "abÿ", "日本語", "é", "x" * 300,
                "special requests", "express special handling requests",
                "PROMO BURNISHED NICKEL", "MEDIUM POLISHED TIN", "aa", "b"]
SEARCH_NEEDLES = ("", "a", "aa", "aab", "ab", "b", "x" * 301, "\x00",
                  "ÿ", "日本", "special", "requests", "PROMO", "ba")
SUBSTRING_ARGS = ((1, 2), (2, 3), (0, 2), (-1, 5), (-4, 4), (-100, 3),
                  (5, 100), (100, 1), (3, -1), (1, 0), (2, 2147483647))
K12_ROWS = 15_000_000  # o_comment at SF 10
K13_ROWS = 1 << 24


def compare_search(col, needle: str, mode: str, label: str, errs: dict,
                   split: int = 0):
    """K12 against its plain version on one (offsets, bytes, validity)
    column: the bool per row, equal."""
    import torch

    from spark_rapids_tpu_torch.columnar import strings as S

    offsets, raw, _ = col
    nb = needle.encode()
    got = S.string_search(offsets, raw, nb, mode, split)
    want = S.string_search_plain(offsets, raw, nb, mode, split)
    check(torch.equal(got, want), f"{label}: K12 {mode} {needle!r} differs")
    errs["string_search"] = max(errs.get("string_search", 0.0),
                                max_abs_err(got.int(), want.int()))
    return got


def compare_substring(col, pos, length, label: str, errs: dict):
    """K13 against its plain version: spans and span validity bit for bit;
    then K7 copies the result."""
    import torch

    from spark_rapids_tpu_torch.columnar import strings as S

    offsets, raw, valid = col
    n = int(valid.shape[0])
    p = S._rows_arg(pos, n, raw.device)
    ln = S._rows_arg(length, n, raw.device)
    got = S.substring_plan(offsets, raw, valid, p, ln)
    want = S.substring_plan_plain(offsets, raw, valid, p, ln)
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          f"{label}: K13 spans differ")
    errs["substring_plan"] = max(errs.get("substring_plan", 0.0),
                                 max_abs_err(got[0], want[0]),
                                 max_abs_err(got[1].int(), want[1].int()))


def raw_string_column(rows, dev):
    """(offsets, bytes, validity) on the card of raw byte rows (they may
    be invalid UTF-8)."""
    import numpy as np
    import torch

    offsets = np.zeros(len(rows) + 1, np.int32)
    offsets[1:] = np.cumsum([len(r) for r in rows])
    raw = np.frombuffer(b"".join(rows) + bytes(8), np.uint8).copy()
    return (torch.from_numpy(offsets).to(dev), torch.from_numpy(raw).to(dev),
            torch.ones(len(rows), dtype=torch.bool, device=dev))


def search_edge_cases(dev, errs: dict) -> int:
    """K12 in every mode and K13 over the corner cases: an empty
    needle, a needle longer than the row, a match on the last byte,
    self-overlapping partial matches, bytes >= 0x80 and NUL, a match that
    would cross into the next row ('xa', 'ab' hold no 'aa'), NULL rows;
    K13 with scalar and per-row arguments and rows that start with a UTF-8
    continuation byte."""
    import numpy as np
    import torch

    n = 0
    for values in (SEARCH_EDGES, [None] * 9, [""] * 5, SEARCH_EDGES * 700):
        col = string_column(values, dev)
        for needle in SEARCH_NEEDLES:
            for mode in ("prefix", "suffix", "contains"):
                compare_search(col, needle, mode, f"K12 {n}", errs)
        for pre, suf in (("a", "b"), ("", "x"), ("special", "requests"),
                         ("aa", "aab"), ("", "")):
            compare_search(col, pre + suf, "prefix_suffix", f"K12 {n}", errs,
                           split=len(pre.encode()))
        for pos, length in SUBSTRING_ARGS:
            compare_substring(col, pos, length, f"K13 {n} ({pos}, {length})",
                              errs)
        rows = int(col[2].shape[0])
        rng = np.random.default_rng(n)
        compare_substring(
            col, torch.from_numpy(rng.integers(-9, 9, rows).astype(
                np.int32)).to(dev),
            torch.from_numpy(rng.integers(-2, 9, rows).astype(
                np.int32)).to(dev), f"K13 {n} per row", errs)
        n += 1
    for rows in ([b"\x80\x80\x80abc", b"a\xc3", b"\xa9\xa9x", b"",
                  b"\xc3\xa9t\xc3\xa9", b"\x80", b"xyz\x80"],
                 [b"ab", b"\x80\x81c\xc3\xa9d", b"\xbf", b"q\x80\x80r"]):
        col = raw_string_column(rows, dev)
        for pos, length in SUBSTRING_ARGS + ((-2, 2147483647),):
            compare_substring(col, pos, length, f"K13 invalid UTF-8 {n}",
                              errs)
        n += 1
    return n


def time_search_kernels(dev, errs: dict) -> dict:
    """K12 at 15M rows shaped like o_comment (tpch.py's pool): CONTAINS
    'special' (the time reported), 'requests', an absent needle and the
    empty needle, PREFIX, SUFFIX and 'express%requests'; K13 at 2^24 rows
    shaped like c_phone (a pool of generated phones, 15 bytes each) at
    SUBSTRING(c_phone, 1, 2) (reported) and (-4, 4), and over multi-byte
    rows. Bounds count the bytes each row needs: CONTAINS reads a row up
    to the end of its first match (all of it without one), PREFIX /
    SUFFIX min(len, |needle|) bytes."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.columnar import strings as S

    rows = {}
    iters, plain_iters = KERNEL_ITERS, PLAIN_ITERS
    n = K12_ROWS
    from spark_rapids_tpu_torch.benchmarks.tpch import _O_COMMENTS

    col = pool_column(_O_COMMENTS, n, 21, dev)
    offsets, raw, _ = col
    counts = np.bincount(np.random.default_rng(21).integers(
        0, len(_O_COMMENTS), n), minlength=len(_O_COMMENTS))
    base = 4 * (n + 1) + n  # offsets read, one byte a row written

    def needed(needle: str, mode: str) -> int:
        total = 0
        for c, v in zip(counts, _O_COMMENTS):
            if mode == "contains":
                at = v.find(needle)
                total += int(c) * (at + len(needle) if at >= 0 else len(v))
            else:
                total += int(c) * min(len(v), len(needle))
        return total

    runs = (("special", "contains", "ms"), ("requests", "contains",
                                           "ms_requests"),
            ("zzz", "contains", "ms_absent"), ("", "contains", "ms_empty"),
            ("express", "prefix", "ms_prefix"),
            ("requests", "suffix", "ms_suffix"))
    for needle, mode, key in runs:
        got = compare_search(col, needle, mode, f"K12 o_comment {key}", errs)
        hits = int(got.sum())
        want_hits = sum(int(c) for c, v in zip(counts, _O_COMMENTS)
                        if (needle in v if mode == "contains" else
                            v.startswith(needle) if mode == "prefix" else
                            v.endswith(needle)))
        check(hits == want_hits, f"K12 {key}: {hits} hits, expected "
              f"{want_hits}")
        nb = needle.encode()
        rows.setdefault("string_search", {})[key] = cuda_ms(
            lambda: S.string_search(offsets, raw, nb, mode), iters)
        rows["string_search"]["bound_" + key] = bound_ms(
            base + needed(needle, mode))
    compare_search(col, "expressrequests", "prefix_suffix",
                   "K12 o_comment 'express%requests'", errs, split=7)
    r = rows["string_search"]
    r["plain_ms"] = cuda_ms(lambda: S.string_search_plain(
        offsets, raw, b"special", "contains"), plain_iters)
    r["library_ms"] = None
    r["shape"] = (f"{n} rows like o_comment, {int(offsets[-1])} bytes; "
                  "CONTAINS 'special'")
    del col, offsets, raw

    rng = np.random.default_rng(22)
    codes = np.array(["13", "17", "18", "23", "29", "30", "31", "32", "33"])
    pool = [f"{codes[i]}-{a}-{b}-{c}" for i, a, b, c in zip(
        rng.integers(0, len(codes), 4096), rng.integers(100, 1000, 4096),
        rng.integers(100, 1000, 4096), rng.integers(1000, 10_000, 4096))]
    n = K13_ROWS
    col = pool_column(pool, n, 23, dev)
    offsets, raw, valid = col
    total = int(offsets[-1])
    for pos, length in ((1, 2), (-4, 4), (0, 3)):
        compare_substring(col, pos, length, f"K13 c_phone ({pos}, "
                          f"{length})", errs)
    compare_substring(pool_column(["☃é-日本語-" + p for p in pool[:64]], n,
                                  24, dev), 2, 5, "K13 multi-byte rows",
                      errs)
    one = torch.ones(1, dtype=torch.int32, device=dev).expand(n)
    two = torch.full((1,), 2, dtype=torch.int32, device=dev).expand(n)
    rows["substring_plan"] = dict(
        ms=cuda_ms(lambda: S.substring_plan(offsets, raw, valid, one, two),
                   iters),
        plain_ms=cuda_ms(lambda: S.substring_plan_plain(
            offsets, raw, valid, one, two), plain_iters),
        library_ms=None,
        bound_ms=bound_ms(4 * (n + 1) + n + total + 4 * (2 * n + 1) +
                          2 * n),
        shape=f"{n} rows like c_phone ({total} bytes), SUBSTRING(c_phone, "
              "1, 2)")
    return rows


def time_kernels(dev, errs: dict, launches: dict, pr_content,
                 d12_rows: int, v2_samples: dict, phase_rows: dict):
    """Each kernel at the flagship's shapes: the partial aggregate's update
    over one cached partition (2^25 rows of a 2^26-row table) for K1-K3,
    the high-cardinality partial output (2^22 rows) for K4."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.columnar.dtypes import DataType
    from spark_rapids_tpu_torch.exec import rowkeys as RK
    from spark_rapids_tpu_torch.ops import hashing as H
    from spark_rapids_tpu_torch.ops.values import ColV
    from spark_rapids_tpu_torch.shuffle import exchange as X

    cap = FLAGSHIP_ROWS // 2
    data = flagship_data(cap, N_KEYS)
    k = torch.as_tensor(data["k"]).to(dev)
    a = torch.as_tensor(data["a"]).to(dev)
    b = torch.as_tensor(data["b"]).to(dev)
    live = (torch.fmod(a, 3) != 0) & (b < 0.9)
    ones = torch.ones(cap, dtype=torch.bool, device=dev)
    c = a * 2 + 1
    kcol = ColV(DataType.INT64, k, ones)
    words = RK.sort_words([RK.key_proxy(kcol)], live)
    n_words = words.shape[0]
    specs = [("sum", c, ones & live), ("count", k, ones & live),
             ("max", a, ones & live)]
    compare_pipeline([kcol], live, specs, 8, "flagship shape", errs)
    order = RK.radix_sort_pairs(words)
    g = RK.group_ids(words, order, live)
    gi = RK.GroupInfo(g[0], g[4], g[2], order, g[1], g[3])
    rows = {}
    iters, plain_iters = KERNEL_ITERS, PLAIN_ITERS

    packed = words[0] * (1 << 32) + words[n_words - 1]
    rows["radix_sort_pairs"] = dict(
        ms=cuda_ms(lambda: RK.radix_sort_pairs(words), iters),
        plain_ms=cuda_ms(lambda: RK.radix_sort_pairs_plain(words),
                         plain_iters),
        library_ms=cuda_ms(lambda: torch.sort(packed, stable=True),
                           plain_iters),
        bound_ms=bound_ms(4 * n_words * cap + 4 * cap),
        shape=f"{n_words} words x {cap} rows")
    srt_key = packed[order.long()]
    rows["group_ids"] = dict(
        ms=cuda_ms(lambda: RK.group_ids(words, order, live), iters),
        plain_ms=cuda_ms(lambda: RK.group_ids_plain(words, order, live),
                         plain_iters),
        library_ms=cuda_ms(lambda: torch.unique_consecutive(
            srt_key, return_inverse=True, return_counts=True), plain_iters),
        bound_ms=bound_ms((4 * n_words + 4 + 1) * cap + 16 * cap),
        shape=f"{cap} rows")
    gid = gi.gid.long().clamp(max=cap - 1)

    def library_k3():
        for op, d, v in specs:
            src = d if op != "count" else v.long()
            red = "sum" if op in ("sum", "count") else "amax"
            torch.zeros(cap, dtype=src.dtype, device=dev).scatter_reduce_(
                0, gid, src, red)

    in_bytes = 8 * cap + sum(d.element_size() * cap + cap
                             for _, d, _ in specs)
    rows["segment_reduce"] = dict(
        ms=cuda_ms(lambda: RK.segment_reduce_many(specs, gi, cap), iters),
        plain_ms=cuda_ms(lambda: [RK.segment_reduce_plain(
            op, d, v, gi, cap) for op, d, v in specs], plain_iters),
        library_ms=cuda_ms(library_k3, plain_iters),
        bound_ms=bound_ms(in_bytes + len(specs) * 9 * cap),
        shape=f"{len(specs)} columns x {cap} rows")
    hcap = 1 << 22
    rng = np.random.default_rng(3)
    hk = ColV(DataType.INT64, torch.as_tensor(
        rng.integers(0, HIGH_CARD_KEYS, hcap)).to(dev),
        torch.ones(hcap, dtype=torch.bool, device=dev))
    hlive = torch.arange(hcap, device=dev) < hcap - 1000
    many = MANY_PARTITIONS
    rows["hash_partition"] = dict(
        ms=cuda_ms(lambda: H.partition_ids([hk], hlive, 8), iters),
        plain_ms=cuda_ms(lambda: H.partition_ids_plain([hk], hlive, 8),
                         plain_iters),
        library_ms=None,
        bound_ms=bound_ms(10 * hcap + 4 * hcap + 36),
        shape=f"1 int64 key x {hcap} rows, 8 partitions",
        # past the shared-memory histogram: counts in device memory
        **{f"ms_{many}": cuda_ms(lambda: H.partition_ids([hk], hlive, many),
                                 iters),
           f"plain_ms_{many}": cuda_ms(lambda: H.partition_ids_plain(
               [hk], hlive, many), plain_iters),
           f"bound_ms_{many}": bound_ms(14 * hcap + 4 * (many + 1))})
    ids, _ = H.partition_ids([hk], hlive, 8)
    ids_many, _ = H.partition_ids([hk], hlive, many)
    rows["route_plan"] = dict(
        ms=cuda_ms(lambda: X.route_plan(ids, 8), iters),
        plain_ms=cuda_ms(lambda: X.route_plan_plain(ids, 8), plain_iters),
        # one call gives the same order: a stable sort of the ids
        library_ms=cuda_ms(lambda: torch.sort(ids, stable=True),
                           plain_iters),
        bound_ms=bound_ms(4 * hcap + 4 * hcap + 36),
        shape=f"{hcap} ids, 8 partitions",
        **{f"ms_{many}": cuda_ms(lambda: X.route_plan(ids_many, many),
                                 iters),
           f"plain_ms_{many}": cuda_ms(lambda: X.route_plan_plain(
               ids_many, many), plain_iters),
           f"bound_ms_{many}": bound_ms(8 * hcap + 4 * (many + 1))})
    passes = (("strings", lambda: time_string_kernels(dev, errs)),
              ("joins", lambda: time_join_kernels(dev, errs)),
              ("searches", lambda: time_search_kernels(dev, errs)),
              ("windows", lambda: time_window_kernels(dev, errs,
                                                      pr_content)),
              ("slice 6", lambda: time_slice6_kernels(dev, errs, d12_rows)),
              ("parquet", lambda: time_parquet_kernels(dev, errs)),
              ("encoded", lambda: time_encoded_kernels(dev, errs)),
              ("parquet v2", lambda: time_parquet_v2_kernels(dev, errs,
                                                             v2_samples)),
              ("orc", lambda: time_orc_kernels(dev, errs)),
              ("memory", lambda: time_memory_kernels(dev, errs)))
    for label, timed in passes:
        t = time.perf_counter()
        rows.update(timed())
        log(f"kernel timing: {label} in {time.perf_counter() - t:.1f} s")
    rows.update(phase_rows)  # timed in phases 14, 15 and 16
    # K3's first at q_agg_join's shape, and its BOOL and any lanes at the
    # rollup's, ride K3's row
    for mode in ("first", "bool", "any"):
        rows["segment_reduce"].update({f"{k}_{mode}": v for k, v in rows.pop(
            f"segment_reduce_{mode}").items()})
    out = []
    for name, (source, replaces, path) in KERNELS.items():
        r = rows[name]
        out.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "path": path,
            "launches": launches[path].get(name, 0),
            "launches_by_path": {p: c.get(name, 0)
                                 for p, c in launches.items()},
            "max_abs_err": errs.get(name, 0.0), "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r.get("bound_by", "bytes"),
            "library_ms": r["library_ms"], "shape": r["shape"],
            **{k: v for k, v in r.items() if k.startswith((
                "ms_", "bound_ms_", "plain_ms_", "library_ms_", "shape_",
                "bytes_bound_ms", "ops_bound_ms", "fp64_ops"))}})
    return out


# ------------------------------------------------- phase 8 (slice 6)
def gen_mortgage(sess, sf: float):
    from spark_rapids_tpu_torch.benchmarks import mortgage

    t = time.perf_counter()
    raw = mortgage.gen_tables(sess, sf=sf,
                              num_partitions=MORTGAGE_PARTITIONS)
    gen_s = time.perf_counter() - t
    rows = {k: sum(b.num_rows for part in v._plan.partitions for b in part)
            for k, v in raw.items()}
    log(f"phase 8: mortgage SF {sf} generated in {gen_s:.1f} s: {rows}")
    return raw, {k: v.cache() for k, v in raw.items()}, rows, gen_s


def probe_d12(sfs) -> list:
    """q_delinquency_12 by scale factor (its explode, PERF.md)."""
    from spark_rapids_tpu_torch.benchmarks import mortgage

    return probe_memory(sfs, gen_mortgage, "performance",
                        mortgage.q_delinquency_12, "q_delinquency_12")


def _exact_percentile(vals, p: float) -> float:
    """The reference's host percentile of sorted float64 values."""
    import numpy as np

    q = p * (len(vals) - 1)
    k = int(np.floor(q))
    frac = q - k
    hi = min(k + 1, len(vals) - 1) if frac > 0 else k
    return float(vals[k] * (1 - frac) + vals[hi] * frac)


def numpy_mortgage_percentiles(perf: dict):
    """q_percentiles by numpy: the 100 loans of highest average rate
    (ties by loan id) with their min, max, average and exact 50/75/90/99th
    percentiles (np.lexsort by loan and rate)."""
    import numpy as np

    loan, rate = perf["loan_id"], perf["interest_rate"]
    cnt = np.bincount(loan)
    total = np.bincount(loan, weights=rate.astype(np.float64))
    ids = np.nonzero(cnt)[0]
    avg = total[ids] / cnt[ids]
    top = ids[np.lexsort((ids, -avg))[:100]]
    m = np.isin(loan, top)
    sel_l, sel_r = loan[m], rate[m].astype(np.float64)
    o = np.lexsort((sel_r, sel_l))
    sel_l, sel_r = sel_l[o], sel_r[o]
    rows = []
    for g in top:
        vals = sel_r[sel_l == g]
        rows.append((int(g), float(vals[0]), float(vals[-1]),
                     float(total[g] / cnt[g]),
                     *[_exact_percentile(vals, p)
                       for p in (0.50, 0.75, 0.90, 0.99)]))
    return rows


def numpy_mortgage_delinquency(perf: dict, acq: dict):
    """q_delinquency by numpy: per-loan worst status, months >= 30 and >=
    90 days delinquent, min unpaid balance and reports (np.bincount, and
    np.minimum.reduceat over the chosen loans' rows), the loans with a
    90-day month, ordered by worst status desc and loan id; every
    acquisition column the join carries is gathered by loan id."""
    import numpy as np

    loan, st, upb = perf["loan_id"], perf["delinq_status"], \
        perf["current_upb"]
    n_loans = len(acq["loan_id"])
    n = np.bincount(loan, minlength=n_loans)
    m30 = np.bincount(loan[st >= 1], minlength=n_loans)
    m90 = np.bincount(loan[st >= 3], minlength=n_loans)
    worst = np.full(n_loans, -1, dtype=np.int64)
    for s in range(int(st.max()) + 1):
        worst[np.bincount(loan[st == s], minlength=n_loans) > 0] = s
    ids = np.nonzero((n > 0) & (m90 > 0))[0]
    top = ids[np.lexsort((ids, -worst[ids]))[:100]]
    m = np.isin(loan, top)
    sel_l, sel_u = loan[m], upb[m]
    o = np.argsort(sel_l, kind="stable")
    uniq, firsts = np.unique(sel_l[o], return_index=True)
    mins = dict(zip(uniq.tolist(),
                    np.minimum.reduceat(sel_u[o], firsts).tolist()))
    rows = []
    for g in top:
        orig = int(acq["orig_upb"][g])
        rows.append((int(g), int(acq["orig_date"][g]), orig,
                     int(acq["credit_score"][g]), float(acq["dti"][g]),
                     int(acq["zip"][g]), float(acq["orig_rate"][g]),
                     str(acq["seller"][g]), int(worst[g]), int(m30[g]),
                     int(m90[g]), mins[int(g)], int(n[g]),
                     1.0 - mins[int(g)] / orig))
    return rows


def numpy_mortgage_agg_join(perf: dict, acq: dict):
    """q_agg_join by numpy: the first 200 loans with performance rows,
    their min rate and (loan_id is unique in acquisition) first() is the
    loan's own orig_rate, exactly."""
    import numpy as np

    loan, rate = perf["loan_id"], perf["interest_rate"]
    ids = np.nonzero(np.bincount(loan))[0][:200]
    m = loan <= ids[-1]
    mins = np.full(int(ids[-1]) + 1, np.inf, dtype=np.float32)
    np.minimum.at(mins, loan[m], rate[m])
    return [(int(g), float(mins[g]), int(g), float(acq["orig_rate"][g]),
             float(acq["dti"][g])) for g in ids]


def mortgage_features(t):
    """q_delinquency's per-loan group-by alone (the many-partitions run)."""
    from spark_rapids_tpu_torch.plan import functions as F

    return (t["performance"].groupBy("loan_id")
            .agg(F.max("delinq_status").alias("worst"),
                 F.min("current_upb").alias("min_upb"),
                 F.count("*").alias("n_reports")))


def run_many_partitions(launches: dict) -> dict:
    """The per-loan group-by at MANY_PARTITIONS_SF with the shuffle at
    MANY_PARTITIONS partitions (K4's device-memory histogram, hash and
    route halves) against its run at MORTGAGE_SHUFFLE partitions."""
    import torch

    from spark_rapids_tpu_torch import cuda_build as CB

    sess = xbb_session()
    raw, tables, rows, _ = gen_mortgage(sess, MANY_PARTITIONS_SF)
    q = mortgage_features(tables)
    want = sorted(q.collect())
    sess.set_conf("rapids.tpu.sql.shuffle.partitions", MANY_PARTITIONS)
    CB.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    got = q.collect()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches["mortgage_many_partitions"] = CB.launch_counts()
    assert_on_device(sess)
    check(sorted(got) == want, f"{MANY_PARTITIONS} shuffle partitions: rows "
          f"differ from the run at {MORTGAGE_SHUFFLE}")
    sess.set_conf("rapids.tpu.sql.shuffle.partitions", MORTGAGE_SHUFFLE)
    log(f"phase 8: the group-by at {MANY_PARTITIONS} shuffle partitions "
        f"({len(got)} rows, {secs:.2f} s) equals its run at "
        f"{MORTGAGE_SHUFFLE}")
    del raw
    release(sess, tables)
    return {"sf": MANY_PARTITIONS_SF, "partitions": MANY_PARTITIONS,
            "rows": len(got), "s": secs,
            "input_rows": rows["performance"]}


def run_mortgage(launches: dict, profile_dir=None) -> dict:
    """Phase 8: the 6 mortgage queries over cached tables at MORTGAGE_SF
    (q_delinquency_12 at MORTGAGE_D12_SF on its own tables: its explode,
    PERF.md), then the many-partitions run."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.benchmarks import mortgage

    sess = xbb_session()
    out = {"sf": MORTGAGE_SF, "d12_sf": MORTGAGE_D12_SF}
    d12 = "mortgage_q_delinquency_12"
    if MORTGAGE_D12_SF != MORTGAGE_SF:
        raw, tables, rows, _ = gen_mortgage(sess, MORTGAGE_D12_SF)
        torch.cuda.reset_peak_memory_stats()
        r = run_xbb_query(sess, d12, mortgage.q_delinquency_12, tables,
                          rows, None, launches, SUITE_WARM_REPS)
        r["sf"] = MORTGAGE_D12_SF
        r["peak_bytes"] = torch.cuda.max_memory_allocated()
        r["checked_against"] = "its own cold run"
        out[d12] = r
        log(f"{d12} at SF {MORTGAGE_D12_SF}: peak device bytes "
            f"{r['peak_bytes']}")
        del raw
        release(sess, tables)
    raw, tables, rows, gen_s = gen_mortgage(sess, MORTGAGE_SF)
    out["gen_s"] = gen_s
    out["table_rows"] = rows
    perf = host_columns(raw["performance"], (
        "loan_id", "interest_rate", "delinq_status", "current_upb"))
    acq = host_columns(raw["acquisition"], (
        "loan_id", "orig_date", "orig_upb", "credit_score", "dti", "zip",
        "orig_rate", "seller"))
    check(bool((acq["loan_id"] == np.arange(len(acq["loan_id"]))).all()),
          "phase 8 reference: loan ids are not arange")
    t = time.perf_counter()
    want = {"q_percentiles": (numpy_mortgage_percentiles(perf), None),
            "q_delinquency": (numpy_mortgage_delinquency(perf, acq), None),
            "q_agg_join": (numpy_mortgage_agg_join(perf, acq), None)}
    log(f"phase 8: numpy references of {sorted(want)} ready in "
        f"{time.perf_counter() - t:.1f} s")
    del perf, acq
    for name in sorted(mortgage.QUERIES):
        path = f"mortgage_{name}"
        if path in out:
            continue
        ref, cols = want.get(name, (None, None))
        torch.cuda.reset_peak_memory_stats()
        r = run_xbb_query(sess, path, mortgage.QUERIES[name], tables, rows,
                          ref, launches, SUITE_WARM_REPS, cols=cols)
        r["peak_bytes"] = torch.cuda.max_memory_allocated()
        r["checked_against"] = "numpy" if name in want else \
            "its own cold run"
        out[path] = r
    out["device_bytes"] = torch.cuda.memory_allocated()
    if profile_dir:
        for name in ("q_percentiles", "q_delinquency"):
            out[f"mortgage_{name}"]["profile"] = profile_query(
                mortgage.QUERIES[name](tables), profile_dir,
                f"mortgage_{name}")
    del raw
    release(sess, tables)
    out["many_partitions"] = run_many_partitions(launches)
    return out


def run_mortgage_small_sf() -> dict:
    """All 6 mortgage queries at MORTGAGE_SMALL_SF on the card against the
    port's numpy CPU engine, rows in order, DOUBLE within TPCH_REL."""
    import spark_rapids_tpu_torch as srt
    from spark_rapids_tpu_torch.benchmarks import mortgage

    card = srt.new_session(TPCH_CONF)
    host = srt.new_session({"rapids.tpu.sql.variableFloatAgg.enabled": True,
                            "rapids.tpu.sql.enabled": False}, device="cpu")
    tabs = []
    for sess in (card, host):
        sess.set_conf("rapids.tpu.sql.shuffle.partitions", MORTGAGE_SHUFFLE)
        tabs.append({k: v.cache() for k, v in mortgage.gen_tables(
            sess, sf=MORTGAGE_SMALL_SF,
            num_partitions=MORTGAGE_PARTITIONS).items()})
    out = {"sf": MORTGAGE_SMALL_SF}
    for q, fn in sorted(mortgage.QUERIES.items()):
        t = time.perf_counter()
        got = fn(tabs[0]).collect()
        card_s = time.perf_counter() - t
        assert_on_device(card)
        t = time.perf_counter()
        want = fn(tabs[1]).collect()
        host_s = time.perf_counter() - t
        worst = check_rows(got, want, f"{q} at SF {MORTGAGE_SMALL_SF} vs the "
                           "CPU engine")
        out[q] = {"rows": len(got), "card_s": card_s, "cpu_engine_s": host_s,
                  "max_rel_diff": worst}
    log(f"phase 8: all 6 queries at SF {MORTGAGE_SMALL_SF} equal the CPU "
        "engine: " + ", ".join(f"{q} {v['rows']}" for q, v in out.items()
                                if q != "sf"))
    for d in tabs[0].values():
        d.unpersist()
    card.last_physical_plan = None
    return out


# ------------------------------------------- slice 6 kernels (K18, K19)
def compare_explode(children, elems, k: int, n: int, with_pos: bool,
                    label: str, errs: dict, strings=None) -> None:
    """K18 against its plain version on one input set; a STRING child
    (offsets, bytes, validity, max_len) goes through K7 with K18's
    replicate index against the plain gather with the plain index."""
    import torch

    from spark_rapids_tpu_torch.columnar import batch as CBT
    from spark_rapids_tpu_torch.exec import expand as E

    out_cap = CBT.bucket_capacity(max(n * k, 1))
    got = E.explode_rows(children, elems, k, n, out_cap, with_pos)
    want = E.explode_rows_plain(children, elems, k, n, out_cap, with_pos)
    for (gd, gv), (wd, wv) in zip(got[0], want[0]):
        check(bits_equal(gd, wd) and torch.equal(gv, wv),
              f"{label}: K18 child column differs")
        errs["explode_rows"] = max(errs.get("explode_rows", 0.0),
                                   max_abs_err(gd, wd))
    if elems:
        check(bits_equal(got[1][0], want[1][0]) and
              torch.equal(got[1][1], want[1][1]),
              f"{label}: K18 element column differs")
    if with_pos:
        check(torch.equal(got[2], want[2]), f"{label}: K18 pos differs")
    check(torch.equal(got[3], want[3]), f"{label}: K18 replicate index "
          "differs")
    if strings is not None:
        offsets, data, valid = strings
        max_len = int((offsets[1:] - offsets[:-1]).max())
        col = CBT.ColumnVector(None, data, valid, offsets, max_len)
        g = CBT.gather_string_col(col, got[3], n * k)
        po, pv = CBT.gather_strings_plan_plain(offsets, valid, want[3],
                                               n * k)
        total = int(po[-1])
        pb = CBT.gather_strings_copy_plain(offsets, data, want[3], po,
                                           max(total, 1))
        check(torch.equal(g.offsets, po) and torch.equal(g.validity, pv)
              and torch.equal(g.data[:total], pb[:total]),
              f"{label}: K7 through K18's index differs")


def compare_percentile(data, valid, gid, cap: int, ps, label: str,
                       errs: dict) -> None:
    import torch

    from spark_rapids_tpu_torch.exec import rowkeys as RK

    got = RK.segment_percentile(data, valid, gid, cap, ps)
    want = RK.segment_percentile_plain(data, valid, gid, cap, ps)
    for p, (o, ov), (po, pov) in zip(ps, got, want):
        check(torch.equal(ov, pov), f"{label}: K19 p={p} validity differs")
        check(bits_equal(o, po), f"{label}: K19 p={p} differs")
        errs["segment_percentile"] = max(errs.get("segment_percentile", 0.0),
                                         max_abs_err(o, po))


EXPLODE_PS = (0.0, 0.25, 0.5, 0.75, 0.9, 0.99, 1.0, 1.0 / 3.0)


def slice6_edge_cases(dev, errs: dict) -> int:
    """K18, K19, K3's first / last and K4 past 4096 buckets against their
    plain versions, bit for bit."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.columnar.dtypes import DataType
    from spark_rapids_tpu_torch.ops.values import ColV

    rng = np.random.default_rng(11)
    n_cases = 0

    def t(x):
        return torch.as_tensor(x).to(dev)

    def children_of(cap):
        v = t(rng.random(cap) > 0.2)
        return [(t(rng.integers(-2**62, 2**62, cap).astype(np.int64)), v),
                (t(rng.random(cap) > 0.5), t(rng.random(cap) > 0.1)),
                (t(rng.integers(-9, 9, cap).astype(np.int32)), v),
                (t(rng.standard_normal(cap).astype(np.float32)), v),
                (t(rng.integers(-9, 9, cap).astype(np.int16)), v),
                (t(rng.integers(-9, 9, cap).astype(np.int8)), v),
                (t(rng.standard_normal(cap)), v)]

    def elems_of(cap, k, nulls):
        return [(t(rng.integers(0, 99, cap).astype(np.int32)),
                 t(rng.random(cap) >= nulls)) for _ in range(k)]

    strs = string_column([STRING_EDGES[i % len(STRING_EDGES)]
                          for i in range(64)], dev)
    for n, k, nulls, pos in ((0, 12, 0.0, True), (1, 12, 0.0, False),
                             (1000, 1, 0.3, True), (5000, 12, 0.3, False),
                             (64, 12, 0.5, True)):
        cap = max(n, 8) if n != 64 else 64
        compare_explode(children_of(cap), elems_of(cap, k, nulls), k, n, pos,
                        f"explode n={n} k={k}", errs,
                        strings=strs if n == 64 else None)
        n_cases += 1
    # K19: NaN, -0.0 / 0.0, +-inf, all-NULL groups, one-row groups, pads
    cap = 4096
    vals = rng.choice(np.array([np.nan, -0.0, 0.0, np.inf, -np.inf, 1.5,
                                -2.25], dtype=np.float64), cap)
    vals[::3] = rng.standard_normal(len(vals[::3]))
    gid = rng.integers(0, 40, cap).astype(np.int32)
    gid[:6] = 40 + np.arange(6)          # one-row groups 40-45
    gid[6:30] = 46 + np.arange(24) % 4   # groups 46-49: all NULL
    gid[-50:] = cap                      # pads
    valid = rng.random(cap) > 0.2
    valid[6:30] = False
    compare_percentile(t(vals), t(valid), t(gid), cap, EXPLODE_PS,
                       "percentile edges", errs)
    # one group past 2^24 rows (the exact integer base), beside small ones
    cap = 1 << 25
    gid = np.zeros(cap, dtype=np.int32)
    gid[(1 << 24) + 3:] = 1 + rng.integers(0, 1000, cap - (1 << 24) - 3)
    compare_percentile(t(rng.standard_normal(cap)), t(np.ones(cap, bool)),
                       t(gid), cap, (0.5, 0.99, 1.0 / 3.0, 1.0),
                       "percentile 2^24 group", errs)
    n_cases += 2
    # K3 first / last (NULL first rows, with and without ignore_nulls), and
    # K4 past 4096 buckets
    for cap, n_parts in ((4096, 4095), (4096, 4096), (1 << 17, 5000),
                         (1 << 17, 65536)):
        k = ColV(DataType.INT64, t(rng.integers(0, 300, cap).astype(
            np.int64)), t(rng.random(cap) > 0.05))
        v = t(rng.random(cap) > 0.4)
        f32 = t(rng.standard_normal(cap).astype(np.float32))
        f32[::5] = float("nan")
        specs = [(op, d, v) for op in ("first", "last", "first_ignore_nulls",
                                       "last_ignore_nulls")
                 for d in (f32, t(rng.standard_normal(cap)),
                           t(rng.integers(-2**62, 2**62, cap)),
                           t(rng.integers(-9, 9, cap).astype(np.int32)),
                           t(rng.random(cap) > 0.5),
                           t(rng.integers(-9, 9, cap).astype(np.int16)))]
        live = t(np.arange(cap) < cap - 7)
        for lo in range(0, len(specs), 8):
            compare_pipeline([k], live, specs[lo:lo + 8], n_parts,
                             f"first/last C={cap} n_parts={n_parts}", errs)
        n_cases += 1
    return n_cases


def d12_batch_rows(joins) -> int:
    """Rows of one joined stream batch that q_delinquency_12 explodes at
    MORTGAGE_D12_SF: its performance rows over the table's partitions when
    the per-loan flags join ran as a broadcast (the stream keeps the cached
    partitions), else over the shuffle partitions."""
    flags = [j for j in joins if "f_loan" in j["join"]]
    parts = MORTGAGE_PARTITIONS if flags and "broadcast" in \
        flags[0]["ran_as"] else MORTGAGE_SHUFFLE
    return int(9_600_000 * MORTGAGE_D12_SF) // parts


def percentile_reads(valid, gid, cap: int, ps) -> int:
    """Values K19's interpolation reads for this data: the distinct sorted
    positions lo and hi of every fraction over the groups with a valid
    value (launch a reads the order, group ids and validity whole)."""
    import torch

    g = gid.long()
    in_group = g < cap
    rows = torch.bincount(g[in_group], minlength=cap)
    cnt = torch.bincount(g[in_group & valid], minlength=cap)
    start = torch.cumsum(rows, 0) - rows
    live = cnt > 0
    c1 = (cnt[live] - 1).to(torch.float64)
    pos = []
    for p in ps:
        q = p * c1
        lo = start[live] + torch.floor(q).long()
        pos += [lo, lo + (q > torch.floor(q)).long()]
    return int(torch.unique(torch.cat(pos)).numel())


def time_slice6_kernels(dev, errs: dict, d12_rows: int) -> dict:
    """K18 at q_delinquency_12's exploded batch, K19 at q_percentiles'
    batch (SF 10: 12M rows a shuffle partition, 500,000 loans), K3's first
    at q_agg_join's acquisition partition (2M rows, every group one row);
    returns their rows and K3 / K4 extra columns."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.columnar.batch import bucket_capacity
    from spark_rapids_tpu_torch.columnar.dtypes import DataType
    from spark_rapids_tpu_torch.exec import expand as E
    from spark_rapids_tpu_torch.exec import rowkeys as RK
    from spark_rapids_tpu_torch.ops.values import ColV

    rng = np.random.default_rng(5)
    iters, plain_iters = KERNEL_ITERS, PLAIN_ITERS
    rows = {}
    # K18: loan_id, ym, delinq_status, current_upb, ever_30/90/180; 12
    # int32 month offsets
    n, k = d12_rows, 12
    cap = bucket_capacity(n)
    out_cap = bucket_capacity(n * k)
    ones = torch.ones(cap, dtype=torch.bool, device=dev)
    children = [
        (torch.as_tensor(rng.integers(0, 4_000_000, cap)).to(dev), ones),
        (torch.as_tensor(rng.integers(24_000, 24_110, cap).astype(
            np.int32)).to(dev), ones),
        (torch.as_tensor(rng.integers(0, 7, cap).astype(np.int32)).to(dev),
         ones),
        (torch.as_tensor(rng.integers(0, 800_000, cap)).to(dev), ones),
        (torch.as_tensor(rng.random(cap) > 0.2).to(dev), ones),
        (torch.as_tensor(rng.random(cap) > 0.6).to(dev), ones),
        (torch.as_tensor(rng.random(cap) > 0.9).to(dev), ones)]
    elems = [(torch.full((cap,), j, dtype=torch.int32, device=dev), ones)
             for j in range(k)]
    compare_explode(children, elems, k, n, False, "q_delinquency_12 batch",
                    errs)

    def library_k18():
        for d, v in children:
            torch.repeat_interleave(d[:n], k)
            torch.repeat_interleave(v[:n], k)
        torch.stack([d[:n] for d, _ in elems], 1).reshape(-1)

    in_bytes = sum((d.element_size() + 1) * n for d, _ in children) + \
        k * 5 * n
    out_bytes = out_cap * (sum(d.element_size() + 1 for d, _ in children)
                           + 5 + 4)
    rows["explode_rows"] = dict(
        ms=cuda_ms(lambda: E.explode_rows(children, elems, k, n, out_cap,
                                          False), iters),
        plain_ms=cuda_ms(lambda: E.explode_rows_plain(
            children, elems, k, n, out_cap, False), plain_iters),
        library_ms=cuda_ms(library_k18, plain_iters),
        bound_ms=bound_ms(in_bytes + out_bytes),
        shape=f"{n} rows x {k} elements, 7 child columns, {out_cap} lanes")
    del children, elems
    # K19: 4 fractions of one column, 12M rows in 500,000 groups
    n, groups = 12_000_000, 500_000
    cap = bucket_capacity(n)
    gid = torch.full((cap,), cap, dtype=torch.int32, device=dev)
    gid[:n] = torch.as_tensor(rng.integers(0, groups, n).astype(
        np.int32)).to(dev)
    data = torch.as_tensor((rng.random(cap) * 5 + 2).astype(
        np.float32).astype(np.float64)).to(dev)
    valid = torch.ones(cap, dtype=torch.bool, device=dev)
    ps = [0.5, 0.75, 0.9, 0.99]
    compare_percentile(data, valid, gid, cap, ps, "q_percentiles batch", errs)
    order = RK.radix_sort_pairs(RK.percentile_sort_words(data, valid, gid,
                                                         cap))
    rows["segment_percentile"] = dict(
        ms=cuda_ms(lambda: RK.percentile_from_order(order, data, valid, gid,
                                                    cap, ps), iters),
        plain_ms=cuda_ms(lambda: RK.segment_percentile_plain(
            data, valid, gid, cap, ps, order=order), plain_iters),
        library_ms=None,
        bound_ms=bound_ms((4 + 4 + 1) * cap + 8 * percentile_reads(
            valid, gid, cap, ps) + len(ps) * 9 * cap),
        ms_with_sort=cuda_ms(lambda: RK.segment_percentile(
            data, valid, gid, cap, ps), iters),
        shape=f"{n} rows, {groups} groups, {len(ps)} fractions, "
              f"capacity {cap}")
    del gid, data, valid, order
    # K3 first: one row a group
    n = 2_000_000
    cap = bucket_capacity(n)
    live = torch.arange(cap, device=dev) < n
    key = ColV(DataType.INT64, torch.arange(cap, device=dev),
               torch.ones(cap, dtype=torch.bool, device=dev))
    gi = RK.group_ids_masked([RK.key_proxy(key)], live, cap)
    rate = torch.as_tensor((rng.random(cap) * 5 + 2).astype(
        np.float32)).to(dev)
    specs = [("first", rate, live)]
    rep = gi.rep_rows.long()
    rows["segment_reduce_first"] = dict(
        ms=cuda_ms(lambda: RK.segment_reduce_many(specs, gi, cap), iters),
        plain_ms=cuda_ms(lambda: RK.segment_reduce_plain(
            "first", rate, live, gi, cap), plain_iters),
        library_ms=cuda_ms(lambda: rate[rep], plain_iters),
        bound_ms=bound_ms((8 + 4 + 1) * cap + (4 + 1) * cap))
    return rows


# ------------------------------------------------- Parquet (slice 7)
PARQUET_TABLES = ("lineitem", "orders", "customer", "supplier", "nation",
                  "region")
DECODE_SHAPE_ROWS = 4 << 20     # bench.py:_worker_decode's file
PARQUET_SHAPE_ROWS = 15_000_000  # one lineitem partition at SF 10
COMMENT_POOL = 1 << 16          # distinct l_comment-like strings


def comment_pool(seed: int):
    """COMMENT_POOL strings like TPC-H's l_comment (text of 10 to 43
    characters, clause 4.2.3: lowercase words and spaces)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz     ", np.uint8)
    chars = alphabet[rng.integers(0, len(alphabet), (COMMENT_POOL, 43))]
    lens = rng.integers(10, 44, COMMENT_POOL)
    return [chars[i, :lens[i]].tobytes().decode() for i in
            range(COMMENT_POOL)]


def pack_bits(values, bw: int) -> bytes:
    """values (< 2^bw each) bit-packed LSB first, bw bits apiece."""
    import numpy as np

    v = np.asarray(values, dtype=np.uint64)
    if bw == 0 or v.size == 0:
        return b""
    bits = ((v[:, None] >> np.arange(bw, dtype=np.uint64)) & np.uint64(1))
    return np.packbits(bits.astype(np.uint8).ravel(),
                       bitorder="little").tobytes()


def hybrid_stream(rng, bw: int, n_runs: int, kind: str):
    """(bytes of an RLE / bit-packed hybrid stream, its values as uint64);
    kind: 'rle', 'bp' or 'mixed' runs."""
    import numpy as np

    from spark_rapids_tpu_torch.io.thrift import uvarint

    out, values = bytearray(), []
    hi = 1 << bw
    for r in range(n_runs):
        if kind == "rle" or (kind == "mixed" and r % 2 == 0):
            count = int(rng.integers(1, 40))
            v = int(rng.integers(0, hi, dtype=np.uint64))
            out += uvarint(count << 1) + v.to_bytes((bw + 7) // 8, "little")
            values.append(np.full(count, v, np.uint64))
        else:
            groups = int(rng.integers(1, 6))
            vals = rng.integers(0, hi, 8 * groups, dtype=np.uint64)
            out += uvarint((groups << 1) | 1) + pack_bits(vals, bw)
            values.append(vals)
    return bytes(out), np.concatenate(values)


def pack_bits_fast(values, bw: int) -> bytes:
    """pack_bits for bw <= 32 through a uint8 bit matrix (no 64-bit
    temporaries), for the fixture's million-row pages."""
    import numpy as np

    v = np.ascontiguousarray(values, dtype="<u4")
    if bw == 0 or v.size == 0:
        return b""
    bits = np.unpackbits(v.view(np.uint8).reshape(-1, 4), axis=1,
                         bitorder="little")[:, :bw]
    return np.packbits(bits.ravel(), bitorder="little").tobytes()


# fixture column specs: (kind, Parquet physical type, converted type or
# None, payload[, options]); "dict": (per-row codes into pool, pool) where
# pool is a numpy array of fixed values or a list of UTF-8 bytes; "plain":
# values; v2 kinds (write_parquet_fixture(..., v2=True)): "delta" values
# (DELTA_BINARY_PACKED, blocks of 128 in 4 miniblocks, as parquet-mr and
# pyarrow write), "bss" values (BYTE_STREAM_SPLIT), "flba" unscaled int64
# (big-endian FIXED_LEN_BYTE_ARRAY decimals, options type_length and
# decimal (precision, scale)), "dlba" / "dba" strings as (offsets [n + 1],
# bytes) (DELTA_LENGTH_BYTE_ARRAY / DELTA_BYTE_ARRAY), "dict_fallback"
# values: a dictionary (first-seen order) while its page stays within the
# writer's dict_limit, then options["fallback"] ("delta" or "plain") pages
# for the rest of the chunk, as parquet-mr and pyarrow fall back. Options:
# valid (a row mask: a False row is NULL), type_length, decimal, fallback.
PHYS_INT32, PHYS_INT64, PHYS_DOUBLE, PHYS_BYTE_ARRAY = 1, 2, 5, 6
PHYS_FLOAT, PHYS_FLBA = 4, 7
CONV_UTF8, CONV_DECIMAL, CONV_DATE, CONV_TIMESTAMP_MICROS = 0, 5, 6, 10
ENC_PLAIN, ENC_RLE, ENC_DELTA, ENC_DLBA, ENC_DBA, ENC_RLE_DICT, ENC_BSS = \
    0, 3, 5, 6, 7, 8, 9
DICT_LIMIT = 1 << 20  # parquet.dictionary.page.size, dictionary_pagesize_limit


def dict_spec(codes, pool, physical: int, converted=None, **options):
    """options: rle=True writes the indices as RLE runs only (a sorted
    column, as Spark's and Arrow's writers emit it)."""
    spec = ("dict", physical, converted, (codes, pool))
    return spec + (options,) if options else spec


def plain_spec(values, physical: int, converted=None):
    return ("plain", physical, converted, values)


def v2_spec(kind: str, payload, physical: int, converted=None, **options):
    return (kind, physical, converted, payload, options)


def uvarint_matrix(u):
    """(uint8 [n, 10] ULEB128 bytes, lengths [n]) of uint64 values."""
    import numpy as np

    u = np.asarray(u, dtype=np.uint64)
    groups = (u[:, None] >> (7 * np.arange(10, dtype=np.uint64))) & \
        np.uint64(0x7F)
    lens = np.ones(len(u), np.int64)
    for k in range(1, 10):
        lens = np.where((u >> np.uint64(7 * k)) != 0, k + 1, lens)
    cont = np.arange(10)[None, :] < (lens[:, None] - 1)
    return (groups | (cont * np.uint64(0x80))).astype(np.uint8), lens


def zigzag64(v):
    import numpy as np

    v = np.asarray(v, dtype=np.int64)
    return (v.view(np.uint64) << np.uint64(1)) ^ (v >> 63).view(np.uint64)


def bit_widths(u):
    """Bits needed for each uint64 value (0 for 0)."""
    import numpy as np

    w = np.zeros(len(u), np.int64)
    for b in range(64):
        w = np.where((u >> np.uint64(b)) != 0, b + 1, w)
    return w


def delta_encode(values, block: int = 128, mbs: int = 4) -> bytes:
    """values as a DELTA_BINARY_PACKED stream, vectorised: per block a
    zigzag min delta, mbs width bytes and the miniblocks' bit-packed
    deltas; trailing miniblocks of the last block carry no bytes. Deltas
    wrap modulo 2^32 for 4-byte values (as parquet-mr and pyarrow write an
    INT32 column: widths stay within 32) and 2^64 otherwise."""
    import numpy as np

    from spark_rapids_tpu_torch.io.thrift import uvarint

    v = np.asarray(values)
    narrow = v.dtype.itemsize == 4
    u_t, s_t = (np.uint32, np.int32) if narrow else (np.uint64, np.int64)
    v = v.astype(s_t)
    n = len(v)
    head = uvarint(block) + uvarint(mbs) + uvarint(n) + uvarint(int(
        zigzag64([v[0] if n else 0])[0]))
    if n <= 1:
        return head
    vpm = block // mbs
    d = np.diff(v.view(u_t))                  # wraps
    nd = len(d)
    nb = -(-nd // block)
    dd = np.zeros(nb * block, u_t)
    dd[:nd] = d
    real = np.arange(nb * block) < nd
    sd = np.where(real, dd.view(s_t), np.iinfo(s_t).max)
    mins = sd.reshape(nb, block).min(axis=1)
    rel = np.where(real, dd - np.repeat(mins.view(u_t), block),
                   u_t(0)).astype(np.uint64).reshape(nb * mbs, vpm)
    mins = mins.astype(np.int64)
    has = np.arange(nb * mbs) * vpm < nd
    widths = np.where(has, bit_widths(rel.max(axis=1)), 0)
    data_len = vpm * widths // 8
    vb, vl = uvarint_matrix(zigzag64(mins))
    blk_len = vl + mbs + data_len.reshape(nb, mbs).sum(axis=1)
    blk_off = np.zeros(nb, np.int64)
    np.cumsum(blk_len[:-1], out=blk_off[1:])
    out = np.zeros(int(blk_len.sum()), np.uint8)
    vmask = np.arange(10)[None, :] < vl[:, None]
    out[(blk_off[:, None] + np.arange(10)[None, :])[vmask]] = vb[vmask]
    wpos = blk_off + vl
    out[(wpos[:, None] + np.arange(mbs)[None, :]).ravel()] = \
        widths.astype(np.uint8)
    mb_start = np.repeat(wpos + mbs, mbs) + np.concatenate(
        [np.zeros((nb, 1), np.int64),
         np.cumsum(data_len.reshape(nb, mbs), axis=1)[:, :-1]],
        axis=1).ravel()
    for w in np.unique(widths[data_len > 0]):
        w = int(w)
        sel = np.flatnonzero((widths == w) & (data_len > 0))
        vals = rel[sel]
        # value j of a miniblock at bit j * w: OR it into 64-bit words,
        # one vectorised step per position over every miniblock
        words = np.zeros((len(sel), (vpm * w + 63) // 64 + 1), np.uint64)
        for j in range(vpm):
            wi, sh = divmod(j * w, 64)
            words[:, wi] |= vals[:, j] << np.uint64(sh)
            if sh + w > 64:
                words[:, wi + 1] |= vals[:, j] >> np.uint64(64 - sh)
        packed = words.view(np.uint8)[:, :vpm * w // 8]
        out[(mb_start[sel][:, None] + np.arange(packed.shape[1])[None, :]
             ).ravel()] = packed.ravel()
    return head + out.tobytes()


def string_rows(offsets, data, rows):
    """(offsets from 0, bytes) of the strings `rows` of (offsets, data)."""
    import numpy as np

    offsets = np.asarray(offsets, np.int64)
    lens = offsets[rows + 1] - offsets[rows]
    new = np.zeros(len(rows) + 1, np.int64)
    np.cumsum(lens, out=new[1:])
    src = np.repeat(offsets[rows] - new[:-1], lens) + np.arange(new[-1])
    return new, np.asarray(data, np.uint8)[src]


def dlba_encode(offsets, data) -> bytes:
    """DELTA_LENGTH_BYTE_ARRAY: the lengths delta-packed, then the bytes."""
    import numpy as np

    offsets = np.asarray(offsets, np.int64)
    return delta_encode(np.diff(offsets)) + np.asarray(
        data, np.uint8)[offsets[0]:offsets[-1]].tobytes()


def dba_encode(offsets, data) -> bytes:
    """DELTA_BYTE_ARRAY: each string's common prefix with the one before
    it (0 for the first) and its suffix length delta-packed, then the
    suffixes, vectorised through a padded byte matrix."""
    import numpy as np

    offsets = np.asarray(offsets, np.int64)
    data = np.asarray(data, np.uint8)
    lens = np.diff(offsets)
    n = len(lens)
    if n == 0:
        return delta_encode([]) + delta_encode([])
    width = max(int(lens.max()), 1)
    col = np.arange(width)[None, :]
    inside = col < lens[:, None]
    mat = np.zeros((n, width), np.uint8)
    mat[inside] = data[(offsets[:-1, None] + col)[inside]]
    plen = np.zeros(n, np.int64)
    if n > 1:
        same = (mat[1:] == mat[:-1]) & inside[1:] & inside[:-1]
        plen[1:] = np.where(same.all(axis=1), np.minimum(lens[1:], lens[:-1]),
                            np.argmin(same, axis=1))
    suffix = inside & (col >= plen[:, None])
    return delta_encode(plen) + delta_encode(lens - plen) + \
        mat[suffix].tobytes()


def bss_encode(values) -> bytes:
    """BYTE_STREAM_SPLIT: byte k of every value, then byte k + 1."""
    import numpy as np

    v = np.ascontiguousarray(values)
    return v.view(np.uint8).reshape(len(v), v.itemsize).T.tobytes()


def flba_encode(unscaled, width: int) -> bytes:
    """Unscaled decimals as width-byte big-endian two's complement."""
    import numpy as np

    v = np.asarray(unscaled, np.int64)
    be = v.astype(">i8").view(np.uint8).reshape(len(v), 8)
    if width <= 8:
        return be[:, 8 - width:].tobytes()
    ext = np.where(v < 0, 0xFF, 0).astype(np.uint8)[:, None].repeat(
        width - 8, axis=1)
    return np.concatenate([ext, be], axis=1).tobytes()


def min_flba_bytes(precision: int) -> int:
    """The fewest bytes that hold `precision` decimal digits (Spark's
    minBytesForPrecision, pyarrow's FLBA width)."""
    b = 1
    while 2 ** (8 * b - 1) < 10 ** precision:
        b += 1
    return b


def first_seen_dictionary(values):
    """(dictionary in first-seen order, codes, first position of each
    entry) of a value array; keys in [0, 2^26) take a dense table instead
    of a sort."""
    import numpy as np

    values = np.asarray(values)
    n = len(values)
    if n and values.dtype.kind in "iu" and values.min() >= 0 and \
            values.max() < 1 << 26:
        first = np.full(int(values.max()) + 1, n, np.int64)
        # the last write of a repeated index wins: writing the rows
        # backwards leaves each value's first row
        first[values[::-1]] = np.arange(n - 1, -1, -1)
        uniq = np.flatnonzero(first < n)
        order = np.argsort(first[uniq], kind="stable")
        rank = np.zeros(len(first), np.int64)
        rank[uniq[order]] = np.arange(len(uniq))
        return uniq[order].astype(values.dtype), rank[values], \
            first[uniq[order]]
    uniq, first, inv = np.unique(values, return_index=True,
                                 return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty(len(uniq), np.int64)
    rank[order] = np.arange(len(uniq))
    return uniq[order], rank[inv.ravel()], first[order]


def write_parquet_fixture(path: str, columns: dict, row_group: int,
                          page_rows: int, first_seen: bool = True,
                          v2: bool = False,
                          dict_limit: int = DICT_LIMIT) -> None:
    """A Parquet file as parquet-mr and pyarrow write one (pyarrow is not
    on the card's machine): OPTIONAL flat columns, data pages of page_rows
    rows (v1, or v2 with v2=True), SNAPPY; a "dict" column has per row
    group a PLAIN dictionary page of the pool entries that group uses, in
    the order the group first meets them (those writers' order; first_seen
    False: pool order), and RLE_DICTIONARY pages (indices one bit-packed
    run, or with the spec's rle option one RLE run per run of equal
    indices in a page); the other kinds are described above. Definition levels are one
    RLE run of 1s, or one bit-packed run where a page has NULLs. Written
    with the port's thrift writer and Snappy."""
    import struct
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from spark_rapids_tpu_torch import native
    from spark_rapids_tpu_torch.io.thrift import CompactWriter, uvarint

    def header(kind, raw_len, wire_len, fid, fields):
        w = CompactWriter()
        w.i32(1, kind)
        w.i32(2, raw_len)
        w.i32(3, wire_len)
        w.begin_struct(fid)
        for k, v in fields:
            w.i32(k, v)
        w.end_struct()
        return w.stop()

    def dict_payload(pool, used):
        if isinstance(pool, np.ndarray):
            return pool[used].tobytes()
        return b"".join(struct.pack("<I", len(pool[i])) + pool[i]
                        for i in used)

    def options(spec):
        return spec[4] if len(spec) > 4 else {}

    def rows_of(spec):
        kind, _, _, payload = spec[:4]
        if kind == "dict":
            return len(payload[0])
        if kind in ("dlba", "dba"):
            return len(payload[0]) - 1
        return len(payload)

    def dict_indices(codes, bw):
        m = len(codes)
        return bytes([bw]) + uvarint(((m + 7) // 8 << 1) | 1) + \
            pack_bits_fast(np.pad(codes, (0, -m % 8)), bw)

    def dict_indices_rle(codes, bw):
        m = len(codes)
        at = np.flatnonzero(codes[1:] != codes[:-1]) + 1 if m else []
        starts = np.concatenate([[0], at]).astype(np.int64) if m else \
            np.zeros(0, np.int64)
        lens = np.diff(np.append(starts, m))
        width = (bw + 7) // 8
        return bytes([bw]) + b"".join(
            uvarint(int(ln) << 1) + int(codes[st]).to_bytes(width, "little")
            for st, ln in zip(starts, lens))

    def column_chunk(name, spec, lo: int, hi: int):
        """(bytes of the column chunk, raw size, wire size, offset of its
        first data page in the chunk, encodings) of rows [lo, hi)."""
        kind, phys, _conv, payload = spec[:4]
        opts = options(spec)
        valid = opts.get("valid")
        vseg = np.ones(hi - lo, bool) if valid is None else \
            np.asarray(valid[lo:hi], bool)
        pres = np.flatnonzero(vseg)              # present rows, from 0
        pstart = np.concatenate([[0], np.cumsum(
            [int(vseg[p:p + page_rows].sum())
             for p in range(0, hi - lo, page_rows)])])
        pages, encs = [], {ENC_RLE}
        n_dict_pages = 0
        if kind == "dict":
            codes, pool = payload
            seg = np.asarray(codes[lo:hi])[pres]
            used = np.flatnonzero(np.bincount(seg, minlength=len(pool)))
            if first_seen:
                # the last write of a repeated index wins: writing the rows
                # backwards leaves each entry's first row
                first = np.zeros(len(pool), np.int64)
                first[seg[::-1]] = np.arange(len(seg) - 1, -1, -1)
                used = used[np.argsort(first[used], kind="stable")]
            remap = np.zeros(len(pool), np.uint32)
            remap[used] = np.arange(len(used), dtype=np.uint32)
            inv = remap[seg]
            n_dict_pages = len(pstart) - 1
            entries = dict_payload(pool, used)
            n_entries = len(used)
        elif kind == "dict_fallback":
            seg = np.asarray(payload[lo:hi])[pres]
            pool, inv, first = first_seen_dictionary(seg)
            ndv = np.searchsorted(first, pstart[1:], side="left")
            ok = ndv * seg.itemsize <= dict_limit
            n_dict_pages = int(np.argmin(ok)) if not ok.all() else len(ok)
            n_entries = int(ndv[n_dict_pages - 1]) if n_dict_pages else 0
            entries = pool[:n_entries].tobytes()
            inv = inv.astype(np.uint32)
        if n_dict_pages:
            bw = max(1, int(n_entries - 1).bit_length())
            pages.append((2, b"", entries, 7, [(1, n_entries), (2, 0)]))
            encs |= {ENC_PLAIN, ENC_RLE_DICT}
        for pi, p in enumerate(range(0, hi - lo, page_rows)):
            m = min(page_rows, hi - lo - p)
            a, b = int(pstart[pi]), int(pstart[pi + 1])
            rows = pres[a:b]                     # present rows of the page
            pv = vseg[p:p + m]
            if b - a == m:
                levels = uvarint(m << 1) + b"\x01"
            else:
                levels = uvarint(((m + 7) // 8 << 1) | 1) + np.packbits(
                    np.pad(pv, (0, -m % 8)), bitorder="little").tobytes()
            pkind = kind
            if kind == "dict_fallback":
                pkind = "dict" if pi < n_dict_pages else \
                    opts.get("fallback", "delta")
            if pkind == "dict":
                body = dict_indices_rle(inv[a:b], bw) if opts.get("rle") \
                    else dict_indices(inv[a:b], bw)
                enc = ENC_RLE_DICT
            elif pkind in ("dlba", "dba"):
                o, d = string_rows(payload[0], payload[1], lo + rows)
                body = dlba_encode(o, d) if pkind == "dlba" else \
                    dba_encode(o, d)
                enc = ENC_DLBA if pkind == "dlba" else ENC_DBA
            else:
                vals = np.asarray(payload[lo:hi])[rows]
                if pkind == "delta":
                    body, enc = delta_encode(vals), ENC_DELTA
                elif pkind == "bss":
                    body, enc = bss_encode(vals), ENC_BSS
                elif pkind == "flba":
                    body, enc = flba_encode(vals, opts["type_length"]), \
                        ENC_PLAIN
                else:
                    body, enc = np.ascontiguousarray(vals).tobytes(), \
                        ENC_PLAIN
            encs.add(enc)
            if v2:
                pages.append((3, levels, body, 8, [
                    (1, m), (2, m - (b - a)), (3, m), (4, enc),
                    (5, len(levels)), (6, 0)]))
            else:
                pages.append((0, b"", struct.pack("<I", len(levels)) +
                              levels + body, 5,
                              [(1, m), (2, enc), (3, 3), (4, 3)]))
        out, raw_total, data_off = [], 0, None
        for pkind, levels, body, fid, fields in pages:
            wire = levels + native.snappy_compress(body)
            hdr = header(pkind, len(levels) + len(body), len(wire), fid,
                         fields)
            if pkind != 2 and data_off is None:
                data_off = sum(len(x) for x in out)
            out.append(hdr + wire)
            raw_total += len(hdr) + len(levels) + len(body)
        chunk = b"".join(out)
        return chunk, raw_total, len(chunk), data_off, sorted(encs), \
            n_dict_pages > 0

    n = rows_of(next(iter(columns.values())))
    groups = []
    # a row group's column chunks build on threads (numpy and Snappy
    # release the GIL) and are written in schema order
    with open(path, "wb") as f, ThreadPoolExecutor(8) as pool_ex:
        f.write(b"PAR1")
        for lo in range(0, n, row_group):
            hi = min(lo + row_group, n)
            chunks = list(pool_ex.map(
                lambda item: column_chunk(item[0], item[1], lo, hi),
                columns.items()))
            metas = []
            for (name, spec), (chunk, raw_total, wire_total, data_off, encs,
                               has_dict) in zip(columns.items(), chunks):
                start = f.tell()
                f.write(chunk)
                metas.append((name, spec[1], has_dict, start,
                              start + data_off, raw_total, wire_total,
                              hi - lo, encs))
            groups.append((metas, hi - lo))
        w = CompactWriter()
        w.i32(1, 1)
        w.list_header(2, 12, len(columns) + 1)
        w.begin_element_struct()
        w.string(4, "schema")
        w.i32(5, len(columns))
        w.end_struct()
        for name, spec in columns.items():
            _kind, phys, conv = spec[:3]
            opts = options(spec)
            w.begin_element_struct()
            w.i32(1, phys)
            if phys == PHYS_FLBA:
                w.i32(2, opts["type_length"])
            w.i32(3, 1)
            w.string(4, name)
            if "decimal" in opts:
                w.i32(6, CONV_DECIMAL)
                w.i32(7, opts["decimal"][1])
                w.i32(8, opts["decimal"][0])
            elif conv is not None:
                w.i32(6, conv)
            w.end_struct()
        w.i64(3, n)
        w.list_header(4, 12, len(groups))
        for metas, rows in groups:
            w.begin_element_struct()
            w.list_header(1, 12, len(metas))
            for name, ptype, has_dict, start, data_off, raw_total, \
                    wire_total, m, encs in metas:
                w.begin_element_struct()
                w.i64(2, start)
                w.begin_struct(3)
                w.i32(1, ptype)
                w.list_header(2, 5, len(encs))
                w.buf += bytes(e << 1 for e in encs)  # zigzag i32
                w.list_header(3, 8, 1)
                w.buf += uvarint(len(name)) + name.encode()
                w.i32(4, 1)                          # SNAPPY
                w.i64(5, m)
                w.i64(6, raw_total)
                w.i64(7, wire_total)
                w.i64(9, data_off)
                if has_dict:
                    w.i64(11, start)
                w.end_struct()
                w.end_struct()
            w.i64(2, sum(x[6] for x in metas))
            w.i64(3, rows)
            w.end_struct()
        w.string(6, "chip_smoke.py fixture")
        footer = w.stop()
        f.write(footer + struct.pack("<I", len(footer)) + b"PAR1")


def write_dict_fixture(path: str, columns: dict, row_group: int,
                       page_rows: int) -> None:
    """A Parquet file of OPTIONAL INT64 / INT32 columns in v1
    RLE_DICTIONARY pages, SNAPPY, as pyarrow writes them by default
    (bench.py:_worker_decode's file): per row group and column a PLAIN
    dictionary page of its sorted distinct values and data pages of
    page_rows rows (write_parquet_fixture)."""
    import numpy as np

    phys = {np.dtype(np.int64): PHYS_INT64, np.dtype(np.int32): PHYS_INT32}
    specs = {}
    for name, arr in columns.items():
        pool, codes = np.unique(arr, return_inverse=True)
        specs[name] = dict_spec(codes.ravel(), pool.astype(arr.dtype),
                                phys[arr.dtype])
    write_parquet_fixture(path, specs, row_group, page_rows,
                          first_seen=False)


def runs_of(tabs, total: int, dev):
    from spark_rapids_tpu_torch.io import parquet_device as PD

    return PD.device_runs(tabs, dev, total)


def stream_tab(chunk: bytes, start: int, bw: int, n: int, shift: int):
    """The run table of the hybrid stream chunk[start:] (n values),
    its outputs shifted by `shift`."""
    import numpy as np

    from spark_rapids_tpu_torch.io import parquet_device as PD

    rt = PD.parse_runs(chunk, start, len(chunk), bw, n)
    return (rt.out_start + shift, rt.is_rle, rt.value, rt.bit_off,
            np.full(len(rt.out_start), bw, np.int32)), rt.total + shift


def compare_k20(chunk, runs, cap: int, label: str, errs: dict) -> None:
    import torch

    from spark_rapids_tpu_torch.io import parquet_device as PD

    got = PD.hybrid_expand(chunk, runs, cap)
    want = PD.hybrid_expand_plain(chunk, runs, cap)
    check(torch.equal(got, want), f"{label}: K20 differs")
    errs["hybrid_expand"] = max(errs.get("hybrid_expand", 0.0),
                                max_abs_err(got, want))


def compare_k22(col, num_rows: int, label: str, errs: dict) -> None:
    import torch

    from spark_rapids_tpu_torch.io import parquet_encode_device as PE

    got = PE.encode_plain_page(col, num_rows)
    want = PE.encode_plain_page_plain(col, num_rows)
    counts = got[2].cpu()
    check(torch.equal(counts, want[2].cpu()), f"{label}: K22 counts "
          f"{counts.tolist()} vs {want[2].tolist()}")
    nb = int(counts[1])
    check(torch.equal(got[0][:nb], want[0][:nb]),
          f"{label}: K22 values differ")
    check(torch.equal(got[1], want[1]), f"{label}: K22 validity bits differ")
    errs["encode_plain_page"] = max(errs.get("encode_plain_page", 0.0),
                                    max_abs_err(got[0][:nb], want[0][:nb]))


def compare_spans(src, starts, lens, valid, rows: int, label: str,
                  errs: dict) -> None:
    import torch

    from spark_rapids_tpu_torch.columnar import batch as CBT

    total = int(torch.where(valid[:rows] & (lens[:rows] >= 0),
                            lens[:rows], 0).sum())
    cap = CBT.bucket_capacity(max(total, 1))
    got = CBT.gather_string_spans(src, starts, lens, valid, rows, cap)
    want = CBT.gather_string_spans_plain(src, starts, lens, valid, rows, cap)
    check(torch.equal(got[0], want[0]) and torch.equal(got[2], want[2]),
          f"{label}: K7 span offsets or validity differ")
    check(torch.equal(got[1][:total], want[1][:total]),
          f"{label}: K7 span bytes differ")
    errs["gather_string_spans"] = max(errs.get("gather_string_spans", 0.0),
                                      max_abs_err(got[1][:total],
                                                  want[1][:total]))


def parquet_edge_cases(dev, errs: dict) -> int:
    """K20, K21, K22 and K7's span entry against their plain versions, bit
    for bit: bit widths 1-32 over RLE, bit-packed and mixed streams (runs
    crossing bytes, a stream ending the chunk, lanes past it, two widths in
    one table); 0 rows, all-NULL pages, required columns, several pages,
    every element width; empty, non-ASCII and 64+ byte strings."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.columnar.batch import (
        ColumnVector,
        bucket_capacity,
    )
    from spark_rapids_tpu_torch.columnar.dtypes import DataType
    from spark_rapids_tpu_torch.io import parquet_device as PD

    rng = np.random.default_rng(23)
    n_cases = 0

    def t(x):
        return torch.as_tensor(x).to(dev)

    # K20
    for bw in (1, 2, 7, 10, 17, 24, 32):
        for kind in ("rle", "bp", "mixed"):
            lead = bytes(rng.integers(0, 256, 3, dtype=np.uint8))
            stream, vals = hybrid_stream(rng, bw, 11, kind)
            chunk = lead + stream
            tab, total = stream_tab(chunk, len(lead), bw, len(vals), 0)
            chunk_t = t(np.frombuffer(chunk, np.uint8).copy())
            compare_k20(chunk_t, runs_of([tab], total, dev),
                        bucket_capacity(total + 9), f"K20 bw={bw} {kind}",
                        errs)
            n_cases += 1
    a, av = hybrid_stream(rng, 3, 6, "mixed")
    b, bv = hybrid_stream(rng, 11, 6, "mixed")
    chunk = a + b
    ta, _ = stream_tab(a, 0, 3, len(av), 0)
    tb, nb = stream_tab(chunk, len(a), 11, len(bv), len(av))
    compare_k20(t(np.frombuffer(chunk, np.uint8).copy()),
                runs_of([ta, tb], nb, dev), bucket_capacity(nb),
                "K20 two widths", errs)
    empty = PD.DeviceRuns(*[t(np.zeros(0, d)) for d in (
        np.int64, np.uint8, np.int32, np.int64, np.int32)], 0)
    compare_k20(t(np.zeros(4, np.uint8)), empty, 8, "K20 no runs", errs)
    n_cases += 2

    # K21: levels from K20 (pages of 300, 0-valid, 500 rows), both modes
    def levels_case(sizes, null_fracs):
        from spark_rapids_tpu_torch.io.thrift import uvarint

        chunk, tabs, rows, present = bytearray(), [], 0, 0
        for n, frac in zip(sizes, null_fracs):
            valid = rng.random(n) >= frac
            start = len(chunk)
            chunk += uvarint(((n + 7) // 8 << 1) | 1) + pack_bits(
                np.pad(valid, (0, -n % 8)).astype(np.uint64), 1)
            tab, _ = stream_tab(bytes(chunk), start, 1, n, rows)
            tabs.append(tab)
            rows += n
            present += int(valid.sum())
        chunk_t = t(np.frombuffer(bytes(chunk), np.uint8).copy())
        cap = bucket_capacity(max(rows, 1))
        return PD.hybrid_expand(chunk_t, runs_of(tabs, rows, dev), cap), \
            rows, present, cap

    widths = ((8, torch.int64, False), (8, torch.float64, False),
              (4, torch.int32, False), (4, torch.float32, False),
              (4, torch.int64, True), (4, torch.int8, False),
              (4, torch.int16, False), (1, torch.bool, False))
    for sizes, fracs in (((300, 200, 500), (0.3, 1.0, 0.0)), ((0,), (0.5,)),
                         ((77,), (1.0,)), ((1000, 24), (0.1, 0.6))):
        levels, rows, present, cap = levels_case(sizes, fracs)
        for in_w, out_dtype, sign in widths:
            n_dict = 5 if in_w == 1 else 300
            dict_bytes = t(rng.integers(0, 2 if in_w == 1 else 256,
                                        n_dict * in_w).astype(np.uint8))
            idx = t(rng.integers(-2, n_dict + 3, bucket_capacity(
                max(present, 1))).astype(np.int32))
            for lv, nr in ((levels, rows - 3 if rows > 3 else rows),
                           (None, rows)):
                compare_k21_pages(lv, max(nr, 0), cap, PD.page_source(
                    dict_bytes, [PD.KIND_DICT], [present], [0], idx=idx,
                    dict_bytes=dict_bytes, dict_w=in_w), in_w, out_dtype,
                    sign, f"K21 dict {sizes}", errs)
                ends = np.cumsum([max(present // 3, 0), present // 3,
                                  present - 2 * (present // 3)])
                src = t(rng.integers(0, 256, in_w * (present + 5) + 40)
                        .astype(np.uint8))
                if in_w == 1:
                    src = src & 1
                pos = np.asarray([3, 3 + in_w * int(ends[0]) + 7,
                                  10 + in_w * int(ends[1]) + 7], np.int64)
                compare_k21_pages(lv, max(nr, 0), cap, PD.page_source(
                    src, [PD.KIND_PLAIN] * 3, ends, pos), in_w, out_dtype,
                    sign, f"K21 plain {sizes}", errs)
                n_cases += 2

    # K22
    strs = STRING_EDGES * 60
    for cap, rows in ((64, 64), (64, 61), (1024, 1000), (8, 0)):
        for frac in (0.0, 0.3, 1.0):
            valid = t(rng.random(cap) >= frac)
            for dt, arr in (
                    (DataType.INT64, rng.integers(-2**62, 2**62, cap)),
                    (DataType.INT32, rng.integers(-2**31, 2**31, cap)
                     .astype(np.int32)),
                    (DataType.FLOAT64, rng.standard_normal(cap)),
                    (DataType.FLOAT32, rng.standard_normal(cap)
                     .astype(np.float32)),
                    (DataType.BOOL, rng.random(cap) < 0.5)):
                compare_k22(ColumnVector(dt, t(arr), valid), rows,
                            f"K22 {dt.name} {rows}/{cap} nulls {frac}", errs)
                n_cases += 1
            offsets, raw, sv = string_column(strs[:cap], dev)
            compare_k22(ColumnVector(DataType.STRING, raw, sv & valid,
                                     offsets, 512), rows,
                        f"K22 STRING {rows}/{cap} nulls {frac}", errs)
            n_cases += 1

    # K7 span entry
    src = t(rng.integers(0, 256, 5000).astype(np.uint8))
    for cap, rows in ((256, 256), (256, 200), (8, 0), (4096, 4000)):
        lens = rng.integers(0, 100, cap)
        lens[::7] = 0
        lens[1::13] = 300
        starts = rng.integers(0, 5000 - 300, cap)
        starts[2::17] = 4990     # bytes past the source read as 0
        valid = rng.random(cap) > 0.2
        compare_spans(src, t(starts.astype(np.int64)),
                      t(lens.astype(np.int32)), t(valid), rows,
                      f"K7 spans {rows}/{cap}", errs)
        n_cases += 1
    return n_cases


def time_parquet_kernels(dev, errs: dict) -> dict:
    """K20, K21, K22 and K7's span entry at one lineitem partition's shape
    (15M rows): K20 over the definition levels of a 15M-row page (one
    bit-packed run of width 1; width-10 dictionary indices beside it); K21
    spreading 15M dictionary-coded int64 values (99% present; PLAIN DOUBLE
    like l_extendedprice and PLAIN DATE like l_shipdate beside it); K22
    encoding l_extendedprice (DOUBLE; an l_comment-like STRING column of
    ~400 MB beside it); the span entry gathering that STRING column's
    values out of its encoded page. Each is checked against its plain
    version at that shape, bit for bit. A bound counts the input rows each
    kernel reads (those below the row count; K22 and the span entry read
    a value only for a live row) and the outputs at the size they are
    written."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.columnar import batch as CBT
    from spark_rapids_tpu_torch.columnar.dtypes import DataType
    from spark_rapids_tpu_torch.io import parquet_device as PD
    from spark_rapids_tpu_torch.io import parquet_encode_device as PE
    from spark_rapids_tpu_torch.io.thrift import uvarint

    n = PARQUET_SHAPE_ROWS
    cap = CBT.bucket_capacity(n)
    rng = np.random.default_rng(29)
    iters, plain_iters = KERNEL_ITERS, PLAIN_ITERS
    rows = {}
    valid = rng.random(n) < 0.99
    present = int(valid.sum())
    lv = uvarint(((n + 7) // 8 << 1) | 1) + np.packbits(
        valid, bitorder="little").tobytes()
    chunk = torch.from_numpy(np.frombuffer(lv, np.uint8).copy()).to(dev)
    tab, total = stream_tab(lv, 0, 1, n, 0)
    runs = runs_of([tab], n, dev)
    compare_k20(chunk, runs, cap, "K20 15M levels", errs)
    idx_vals = rng.integers(0, 1000, present)
    ist = uvarint(((present + 7) // 8 << 1) | 1) + pack_bits(
        np.pad(idx_vals, (0, -present % 8)), 10)
    ichunk = torch.from_numpy(np.frombuffer(ist, np.uint8).copy()).to(dev)
    itab, _ = stream_tab(ist, 0, 10, present, 0)
    iruns = runs_of([itab], present, dev)
    cap_p = CBT.bucket_capacity(present)
    compare_k20(ichunk, iruns, cap_p, "K20 15M indices", errs)
    rows["hybrid_expand"] = dict(
        ms=cuda_ms(lambda: PD.hybrid_expand(chunk, runs, cap), iters),
        plain_ms=cuda_ms(lambda: PD.hybrid_expand_plain(chunk, runs, cap),
                         plain_iters),
        library_ms=None, bound_ms=bound_ms(len(lv) + 4 * cap),
        ms_w10=cuda_ms(lambda: PD.hybrid_expand(ichunk, iruns, cap_p),
                       iters),
        bound_ms_w10=bound_ms(len(ist) + 4 * cap_p),
        shape=f"{n} levels, one bit-packed run of width 1 (w10: {present} "
              "dictionary indices of width 10)")
    levels = PD.hybrid_expand(chunk, runs, cap)
    idx = PD.hybrid_expand(ichunk, iruns, cap_p)
    dvals = torch.as_tensor(rng.integers(-2**40, 2**40, 1000)).to(dev)
    dsrc = PD.page_source(dvals.view(torch.uint8), [PD.KIND_DICT],
                          [present], [0], idx=idx,
                          dict_bytes=dvals.view(torch.uint8))
    compare_k21_pages(levels, n, cap, dsrc, 8, torch.int64, False,
                      "K21 15M dictionary", errs)
    f64 = torch.as_tensor(rng.random(present) * 1e5).to(dev)
    psrc = PD.page_source(f64.view(torch.uint8), [PD.KIND_PLAIN], [present],
                          [0])
    d32 = torch.as_tensor(rng.integers(8000, 10600, present).astype(
        np.int32)).to(dev)
    dsrc32 = PD.page_source(d32.view(torch.uint8), [PD.KIND_PLAIN],
                            [present], [0])
    compare_k21_pages(levels, n, cap, psrc, 8, torch.float64, False,
                      "K21 15M PLAIN DOUBLE", errs)
    compare_k21_pages(levels, n, cap, dsrc32, 4, torch.int32, False,
                      "K21 15M PLAIN DATE", errs)
    idx_l = idx[:present].long()
    rows["page_decode_fixed"] = dict(
        ms=cuda_ms(lambda: PD.page_decode_pages(levels, n, cap, dsrc, 8,
                                                torch.int64), iters),
        plain_ms=cuda_ms(lambda: PD.page_decode_pages_plain(
            levels, n, cap, dsrc, 8, torch.int64, False), plain_iters),
        library_ms=cuda_ms(lambda: dvals[idx_l], plain_iters),
        bound_ms=bound_ms(4 * n + 4 * present + 8000 + 9 * cap),
        ms_plain_f64=cuda_ms(lambda: PD.page_decode_pages(
            levels, n, cap, psrc, 8, torch.float64), iters),
        bound_ms_plain_f64=bound_ms(4 * n + 8 * present + 9 * cap),
        ms_plain_date=cuda_ms(lambda: PD.page_decode_pages(
            levels, n, cap, dsrc32, 4, torch.int32), iters),
        bound_ms_plain_date=bound_ms(4 * n + 4 * present + 5 * cap),
        shape=f"{n} rows, {present} present: dictionary int64 (1000 "
              "entries); plain_f64 / plain_date PLAIN pages")
    del levels, idx, idx_l, f64, d32
    price = torch.as_tensor(rng.random(cap) * 1e5).to(dev)
    pvalid = torch.arange(cap, device=dev) < n
    pcol = CBT.ColumnVector(DataType.FLOAT64, price, pvalid)
    compare_k22(pcol, n, "K22 15M DOUBLE", errs)
    offsets, raw, sv = pool_column(comment_pool(31), cap, 31, dev)
    sv = sv & pvalid
    scol = CBT.ColumnVector(DataType.STRING, raw, sv, offsets, 43)
    compare_k22(scol, n, "K22 15M STRING", errs)
    s_bytes = int(offsets[n])
    # every row below n is live: validity and values read for n rows,
    # n values and the packed bits of all cap rows written
    rows["encode_plain_page"] = dict(
        ms=cuda_ms(lambda: PE.encode_plain_page(pcol, n), iters),
        plain_ms=cuda_ms(lambda: PE.encode_plain_page_plain(pcol, n),
                         plain_iters),
        library_ms=cuda_ms(lambda: price[pvalid], plain_iters),
        bound_ms=bound_ms(n + 8 * n + 8 * n + cap // 8 + 16),
        ms_string=cuda_ms(lambda: PE.encode_plain_page(scol, n), iters),
        bound_ms_string=bound_ms(n + 4 * (n + 1) + s_bytes +
                                 s_bytes + 4 * n + cap // 8 + 16),
        shape=f"{n} DOUBLE rows like l_extendedprice (string: {n} rows "
              f"like l_comment, {s_bytes} bytes)")
    stream, _, counts = PE.encode_plain_page(scol, n)
    lens = (offsets[1:] - offsets[:-1]).to(torch.int32)
    lens = torch.where(sv, lens, 0)
    piece = (lens + 4).long() * sv
    starts = torch.cumsum(piece, 0) - piece + 4
    total = int(lens.sum())
    compare_spans(stream, starts, lens, sv, n, "K7 spans 15M", errs)
    byte_cap = CBT.bucket_capacity(total)
    rows["gather_string_spans"] = dict(
        ms=cuda_ms(lambda: CBT.gather_string_spans(
            stream, starts, lens, sv, n, byte_cap), iters),
        plain_ms=cuda_ms(lambda: CBT.gather_string_spans_plain(
            stream, starts, lens, sv, n, byte_cap), plain_iters),
        library_ms=None,
        # lens and validity of n rows, the starts of the n live rows and
        # their bytes read; offsets, validity of cap rows and bytes written
        bound_ms=bound_ms(4 * n + n + 8 * n + total + 4 * (cap + 1) + cap +
                          total),
        shape=f"{n} rows like l_comment out of their PLAIN page, "
              f"{total} bytes")
    return rows


def check_round_trip(sess, raw_df, path: str, what: str,
                     fmt: str = "parquet") -> int:
    """The table read back from `path` (Parquet or ORC) equals the
    generated one column for column, bit for bit (fixed-width data and
    validity; STRING offsets and bytes), compared on the card."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.columnar.batch import concat_batches

    df = getattr(sess.read, fmt)(path)
    plan = sess._physical_plan(df._plan)
    assert_on_device(sess)
    pb = plan.children[0].execute(sess.exec_context())
    got = concat_batches([b for p in range(pb.num_partitions)
                          for b in pb.iterator(p)])
    n = got.host_rows()
    parts = [b for part in raw_df._plan.partitions for b in part]
    check(n == sum(b.num_rows for b in parts), f"{what}: {n} rows back")
    for i, attr in enumerate(raw_df.schema):
        col = got.columns[i]
        hosts = [b.columns[i] for b in parts]
        valid = np.concatenate([h.validity for h in hosts])
        check(torch.equal(col.validity[:n].cpu(), torch.from_numpy(valid)),
              f"{what}: {attr.name} validity differs")
        if attr.data_type.is_string:
            offs, raws, base = [np.zeros(1, np.int64)], [], 0
            for h in hosts:
                o, r = h.utf8()
                offs.append(o[1:].astype(np.int64) + base)
                raws.append(r[:int(o[-1])])
                base += int(o[-1])
            want_o = np.concatenate(offs).astype(np.int32)
            check(torch.equal(col.offsets[:n + 1].cpu(),
                              torch.from_numpy(want_o)),
                  f"{what}: {attr.name} offsets differ")
            check(torch.equal(col.data[:base].cpu(),
                              torch.from_numpy(np.concatenate(raws))),
                  f"{what}: {attr.name} bytes differ")
        else:
            data = np.concatenate([np.where(h.validity, h.data, 0).astype(
                h.data.dtype) for h in hosts])
            check(torch.equal(col.data[:n].cpu().view(torch.uint8),
                              torch.from_numpy(data.view(np.uint8))),
                  f"{what}: {attr.name} values differ")
    return n


def assert_file_leaves(sess) -> None:
    from spark_rapids_tpu_torch.io.scan import TpuFileScanExec

    plan = sess.last_physical_plan
    leaves = plan.collect_nodes(lambda x: not x.children)
    check(leaves and all(isinstance(x, TpuFileScanExec) for x in leaves),
          f"not every leaf is a TpuFileScanExec: {leaves}")


def scan_host_s(sess) -> float:
    from spark_rapids_tpu_torch.io.scan import SCAN_HOST_SECONDS, \
        TpuFileScanExec

    return sum(x.metrics[SCAN_HOST_SECONDS] for x in
               sess.last_physical_plan.collect_nodes(
                   lambda x: isinstance(x, TpuFileScanExec)))


def comment_round_trip(sess, root: str, profile_dir=None) -> dict:
    """One lineitem partition's worth of an l_comment-like column
    (PARQUET_SHAPE_ROWS rows, ~400 MB of text in one STRING page of one
    file, beside an int64 key) written by df.write.parquet and read back
    on the card bit for bit; with a profile directory, a second write of
    it runs under cProfile. The files are removed at the end."""
    import glob
    import shutil

    import numpy as np

    from spark_rapids_tpu_torch import cuda_build as CB
    from spark_rapids_tpu_torch.columnar.batch import HostColumnVector

    n = PARQUET_SHAPE_ROWS
    codes = np.random.default_rng(37).integers(0, COMMENT_POOL, n)
    df = sess.createDataFrame(
        {"l_orderkey": np.arange(n, dtype=np.int64),
         "l_comment": HostColumnVector.from_pool(comment_pool(37), codes)},
        [("l_orderkey", "long"), ("l_comment", "string")])
    path = os.path.join(root, "l_comment")
    CB.reset_launch_counts()
    t = time.perf_counter()
    df.write.parquet(path)
    write_s = time.perf_counter() - t
    assert_on_device(sess)
    # a host table alone: the writer uploads it and encodes on the card
    check(CB.launch_counts().get("encode_plain_page", 0) == 2,
          f"l_comment write: K22 launches {CB.launch_counts()}")
    nbytes = sum(os.path.getsize(p) for p in glob.glob(
        os.path.join(path, "*.parquet")))
    t = time.perf_counter()
    rows = check_round_trip(sess, df, path, "l_comment round trip")
    read_s = time.perf_counter() - t
    text = int(df._plan.partitions[0][0].columns[1].utf8()[0][-1])
    shutil.rmtree(path, ignore_errors=True)
    log(f"parquet: l_comment-like column ({rows} rows, {text} bytes of "
        f"text) written in {write_s:.3f} s ({nbytes} bytes) and read back "
        f"bit for bit in {read_s:.3f} s")
    out = {"rows": rows, "text_bytes": text, "write_s": write_s,
           "file_bytes": nbytes, "read_and_check_s": read_s}
    if profile_dir:
        out["profiled_write_s"] = profile_host(
            lambda: df.write.parquet(path), profile_dir,
            "parquet_comment_write")
        shutil.rmtree(path, ignore_errors=True)
        log(f"parquet: the l_comment-like write again under cProfile: "
            f"{out['profiled_write_s']:.3f} s")
    return out


def run_parquet(sess, raw, tables, wants: dict, input_rows: dict,
                launches: dict, profile_dir=None) -> dict:
    """The Parquet phase, over phase 4's cached SF 10 tables: write six
    tables (K22), read orders and an l_comment-like column back bit for
    bit, q1, q6, q3 and q5 over the files (one cold and PARQUET_WARM_REPS
    warm runs each,
    every leaf a TpuFileScanExec, rows against numpy), then the
    reference's decode shape; the files are removed at the end."""
    import glob
    import shutil
    import tempfile

    import torch

    from spark_rapids_tpu_torch import cuda_build as CB
    from spark_rapids_tpu_torch.benchmarks import tpch

    root = tempfile.mkdtemp(prefix="chip_smoke_parquet_")
    out = {"write": {}}
    try:
        CB.reset_launch_counts()
        for name in PARQUET_TABLES:
            path = os.path.join(root, name)
            torch.cuda.synchronize()
            t = time.perf_counter()
            tables[name].write.parquet(path)
            secs = time.perf_counter() - t
            assert_on_device(sess)
            nbytes = sum(os.path.getsize(p) for p in glob.glob(
                os.path.join(path, "*.parquet")))
            out["write"][name] = {"s": secs, "bytes": nbytes}
            log(f"parquet: wrote {name} in {secs:.3f} s, {nbytes} bytes")
        launches["parquet_write"] = CB.launch_counts()
        t = time.perf_counter()
        n = check_round_trip(sess, raw["orders"], os.path.join(root,
                                                              "orders"),
                             "orders round trip")
        out["orders_round_trip"] = {"rows": n,
                                    "s": time.perf_counter() - t}
        log(f"parquet: orders ({n} rows) read back bit for bit")
        out["comment_round_trip"] = comment_round_trip(sess, root,
                                                       profile_dir)
        ptables = {k: sess.read.parquet(os.path.join(root, k))
                   for k in PARQUET_TABLES}
        for q in ("q1", "q6", "q3", "q5"):
            name = f"parquet_tpch_{q}"
            CB.reset_launch_counts()
            out[name] = run_query(sess, tpch.QUERIES[q](ptables),
                                  wants[f"tpch_{q}"], name,
                                  PARQUET_WARM_REPS)
            launches[name] = CB.launch_counts()
            assert_file_leaves(sess)
            host = scan_host_s(sess)
            out[name].update(
                input_rows=input_rows[q],
                rows_per_s=input_rows[q] / best_s(out[name]),
                last_run_scan_host_s=host,
                last_run_rest_s=last_s(out[name]) - host)
            log(f"{name}: scan host {host:.3f} s of the last run "
                f"({last_s(out[name]):.3f} s)")
        if profile_dir:
            out["parquet_tpch_q1"]["profile"] = profile_query(
                tpch.q1(ptables), profile_dir, "parquet_tpch_q1")
        out.update(run_decode_shape(sess, root, launches))
        v2, out["l_extendedprice_sample"] = run_parquet_v2_tpch(
            sess, raw, wants, input_rows, launches, root)
        out.update(v2)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def run_decode_shape(sess, root: str, launches: dict) -> dict:
    """bench.py:_worker_decode's file (4 << 20 rows of a, b int64 and c
    int32, seed 7; v1 dictionary pages, SNAPPY, row groups of 2^19) and
    its query, sum(a), sum(b), sum(c), against numpy."""
    import numpy as np

    from spark_rapids_tpu_torch import cuda_build as CB
    from spark_rapids_tpu_torch.plan import functions as F

    n = DECODE_SHAPE_ROWS
    rng = np.random.default_rng(7)
    cols = {"a": rng.integers(0, 1000, n).astype(np.int64),
            "b": rng.integers(0, 50, n).astype(np.int64),
            "c": rng.integers(0, 200, n).astype(np.int32)}
    path = os.path.join(root, "decode_shape.parquet")
    t = time.perf_counter()
    write_dict_fixture(path, cols, 1 << 19, 1 << 17)
    write_s = time.perf_counter() - t
    want = [tuple(int(v.sum()) for v in cols.values())]
    q = sess.read.parquet(path).agg(F.sum("a").alias("sa"),
                                    F.sum("b").alias("sb"),
                                    F.sum("c").alias("sc"))
    out = {}
    # encoding on (the default: a and b stay encoded, and their sums
    # materialize them through K23), then off
    for label, on in (("", True), ("_off", False)):
        name = f"parquet_decode_shape{label}"
        sess.set_conf("rapids.tpu.sql.encoded.enabled", on)
        CB.reset_launch_counts()
        res = run_query(sess, q, want, name, PARQUET_WARM_REPS)
        launches[name] = CB.launch_counts()
        assert_file_leaves(sess)
        res.update(rows=n, file_bytes=os.path.getsize(path),
                   fixture_write_s=write_s, decoded_bytes=n * 20,
                   gbps=n * 20 / best_s(res) / 1e9,
                   last_run_scan_host_s=scan_host_s(sess),
                   encoded="on" if on else "off")
        log(f"{name} (encoding {res['encoded']}): {res['gbps']:.3f} GB/s "
            f"decoded ({best_s(res):.4f} s)")
        out[name] = res
    sess.set_conf("rapids.tpu.sql.encoded.enabled", True)
    return out


# ------------------------------------------------- encoded phase (slice 8)
ENCODED_ROWS = 60_000_000        # the SF 10 lineitem count
ENCODED_ROW_GROUP = 7_500_000    # 8 row groups
ENCODED_PAGE_ROWS = 1 << 20
TPCH_DICT_ROW_GROUP = 7_500_000
ENC_FLAGS = ["A", "N", "R"]
ENC_STATUS = ["F", "O"]
ENC_MODES = ["AIR", "MAIL", "SHIP", "TRUCK", "RAIL", "FOB", "REG AIR"]
ENC_COMMENTS = [f"clerk notes row class {i:03d}: carefully packed and "
                "inspected" for i in range(200)]
ENC_MODE_COST = [3, 1, 2, 2, 2, 4, 3]
ENCODED_OFF = {"rapids.tpu.sql.encoded.enabled": False}
ENC_SHUFFLED = {"rapids.tpu.sql.autoBroadcastJoinThreshold": 0,
                "rapids.tpu.sql.adaptive.runtimeBroadcastJoin.enabled":
                False}
_ENC_READ = ("hybrid_expand", "page_decode_codes")
_ENC_GROUP = ("radix_sort_pairs", "group_ids", "segment_reduce",
              "hash_partition_codes")
# the kernels each encoded path must launch (with encoding on)
PATH_KERNELS.update({
    "encoded_q_agg": _ENC_READ + _ENC_GROUP + ("dict_materialize_fixed",
                                               "remap_codes"),
    "encoded_q_join": _ENC_READ + _ENC_GROUP + _JOIN + (
        "remap_codes", "dict_materialize_strings"),
    "encoded_q_sort": _ENC_READ + _ENC_GROUP + ("route_plan",
                                                "remap_codes"),
    "encoded_q_minmax": _ENC_READ + _ENC_GROUP + ("remap_codes",),
    "encoded_tpch_q1": _ENC_READ + _ENC_GROUP + ("page_decode_fixed",
                                                 "remap_codes"),
    "encoded_tpch_q12": _ENC_READ + _ENC_GROUP + _JOIN + (
        "page_decode_fixed", "dict_materialize_fixed"),
    "parquet_decode_shape": ("segment_reduce", "hybrid_expand",
                             "page_decode_fixed", "page_decode_codes",
                             "dict_materialize_fixed"),
    "parquet_decode_shape_off": ("segment_reduce",) + _PQ_READ,
})
# phase 19: the run-collapsed update compiles into K48 and materializes
# the summed l_bucket (K23) over the run rows; the rank-space window's
# exchange hashes codes and its concat aligns dictionaries (K24); the
# serialized tier splits a batch past the zero-copy cap per target (K4's
# route, K46 for fixed columns) and compacts the zero-copy pieces (K31)
_WINDOW = ("radix_sort_pairs", "window_segments", "window_rank_offset")
_SER_SORT = _ENC_READ + _ENC_GROUP + ("compact_fixed", "route_plan",
                                      "remap_codes")
PATH_KERNELS.update({
    "compressed_q_runs": _ENC_READ + _ENC_GROUP + (
        "stage_program", "dict_materialize_fixed"),
    "compressed_q_runs_off": _ENC_READ + _ENC_GROUP + (
        "stage_program", "dict_materialize_fixed"),
    "compressed_q_sort_rle": _ENC_READ + _ENC_GROUP + ("route_plan",
                                                       "remap_codes"),
    "compressed_q_minmax_rle": _ENC_READ + _ENC_GROUP + ("remap_codes",),
    "compressed_window": _ENC_READ + _WINDOW + (
        "hash_partition_codes", "remap_codes", "stage_program"),
    "compressed_window_off": _WINDOW + (
        "hybrid_expand", "page_decode_fixed", "gather_strings",
        "string_hash_words", "hash_partition"),
    "serialized_q_join": _ENC_READ + _ENC_GROUP + _JOIN + (
        "route_plan", "assemble_routed_fixed", "compact_fixed"),
    "serialized_q_join_off": _JOIN + (
        "hybrid_expand", "page_decode_fixed", "gather_strings",
        "string_hash_words", "hash_partition", "route_plan",
        "compact_fixed"),
    "serialized_q_sort": _SER_SORT,
    "serialized_tpch_q5": _GROUP_BY + _JOIN + (
        "route_plan", "assemble_routed_fixed", "gather_strings",
        "compact_fixed"),
    "serialized_q_sort_fetch_loss": _SER_SORT,
})


def pool_bytes(pool):
    return [v.encode() for v in pool]


def encoded_bench_files(root: str) -> dict:
    """bench.py main_encoded's table (seed 42) and main_encoded_rank's
    (seed 7) at ENCODED_ROWS rows, 8 row groups, pages of 2^20 rows, every
    column a SNAPPY v1 dictionary chunk, and the 7-row modes table. The
    draws are bench.py's: rng.choice(pool, n) draws rng.integers(0,
    len(pool), n). Returns the paths and the columns as pool codes."""
    import numpy as np

    n = ENCODED_ROWS
    t = time.perf_counter()
    rng = np.random.default_rng(42)
    li = {"l_returnflag": rng.integers(0, 3, n).astype(np.int32),
          "l_linestatus": rng.integers(0, 2, n).astype(np.int32),
          "l_shipmode": rng.integers(0, 7, n).astype(np.int32),
          "l_comment": rng.integers(0, 200, n).astype(np.int32),
          "l_quantity": rng.integers(1, 51, n),
          "l_extendedprice": rng.integers(100, 100_000, n)}
    rng = np.random.default_rng(7)
    mode = rng.integers(0, 7, n)
    by_name = np.argsort(np.array(ENC_MODES))     # np.sort of the strings
    counts = np.bincount(mode, minlength=7)
    rk = {"l_shipmode": np.repeat(by_name, counts[by_name]).astype(np.int32),
          "l_returnflag": rng.integers(0, 3, n).astype(np.int32),
          "l_quantity": rng.integers(1, 51, n),
          "l_bucket": np.sort(rng.integers(0, 32, n)).astype(np.int64)}
    del mode

    def ints(v, lo: int, hi: int):
        return dict_spec((v - lo).astype(np.int32),
                         np.arange(lo, hi, dtype=np.int64), PHYS_INT64)

    def strs(codes, pool):
        return dict_spec(codes, pool_bytes(pool), PHYS_BYTE_ARRAY,
                         CONV_UTF8)

    paths = {k: os.path.join(root, f"{k}.parquet")
             for k in ("lineitem_like", "modes", "sorted_lowcard")}
    write_parquet_fixture(paths["lineitem_like"], {
        "l_returnflag": strs(li["l_returnflag"], ENC_FLAGS),
        "l_linestatus": strs(li["l_linestatus"], ENC_STATUS),
        "l_shipmode": strs(li["l_shipmode"], ENC_MODES),
        "l_comment": strs(li["l_comment"], ENC_COMMENTS),
        "l_quantity": ints(li["l_quantity"], 1, 51),
        "l_extendedprice": ints(li["l_extendedprice"], 100, 100_000)},
        ENCODED_ROW_GROUP, ENCODED_PAGE_ROWS)
    write_parquet_fixture(paths["modes"], {
        "m_mode": strs(np.arange(7, dtype=np.int32), ENC_MODES),
        "m_cost": ints(np.asarray(ENC_MODE_COST, np.int64), 0, 8)}, 7, 7)
    write_parquet_fixture(paths["sorted_lowcard"], {
        "l_shipmode": strs(rk["l_shipmode"], ENC_MODES),
        "l_returnflag": strs(rk["l_returnflag"], ENC_FLAGS),
        "l_quantity": ints(rk["l_quantity"], 1, 51),
        "l_bucket": ints(rk["l_bucket"], 0, 32)},
        ENCODED_ROW_GROUP, ENCODED_PAGE_ROWS)
    secs = time.perf_counter() - t
    log(f"encoded: bench files ({n} rows each) written in {secs:.1f} s")
    return {"paths": paths, "li": li, "rk": rk, "write_s": secs}


def numpy_enc_agg(li: dict):
    """q_agg: l_returnflag = 'A', by (l_linestatus, l_shipmode): count,
    sum(l_quantity), sum(l_extendedprice)."""
    import numpy as np

    m = li["l_returnflag"] == ENC_FLAGS.index("A")
    key = li["l_linestatus"][m].astype(np.int64) * 7 + li["l_shipmode"][m]
    n = np.bincount(key, minlength=14)
    qty = np.bincount(key, li["l_quantity"][m], minlength=14)
    rev = np.bincount(key, li["l_extendedprice"][m], minlength=14)
    # int64 sums: float64 bincount is exact below 2^53 (~5e11 here)
    return sorted((ENC_STATUS[k // 7], ENC_MODES[k % 7], int(n[k]),
                   int(qty[k]), int(rev[k])) for k in range(14) if n[k])


def numpy_enc_join(li: dict):
    """q_join: every row meets its one mode: by l_returnflag count,
    sum(m_cost), max(l_comment) (the comments order by their index)."""
    import numpy as np

    f = li["l_returnflag"]
    cost = np.asarray(ENC_MODE_COST, np.int64)[li["l_shipmode"]]
    n = np.bincount(f, minlength=3)
    c = np.bincount(f, cost, minlength=3)
    mx = np.full(3, -1, np.int64)
    np.maximum.at(mx, f, li["l_comment"])
    return sorted((ENC_FLAGS[k], int(n[k]), int(c[k]), ENC_COMMENTS[mx[k]])
                  for k in range(3) if n[k])


def numpy_enc_sort(rk: dict):
    """q_sort: by (l_returnflag, l_shipmode) sum(l_quantity), ordered."""
    import numpy as np

    key = rk["l_returnflag"].astype(np.int64) * 7 + rk["l_shipmode"]
    n = np.bincount(key, minlength=21)
    qty = np.bincount(key, rk["l_quantity"], minlength=21)
    return sorted((ENC_FLAGS[k // 7], ENC_MODES[k % 7], int(qty[k]))
                  for k in range(21) if n[k])


def numpy_enc_minmax(rk: dict):
    """q_minmax: by l_returnflag min / max(l_shipmode), count."""
    import numpy as np

    rank = np.argsort(np.argsort(np.array(ENC_MODES)))  # code -> rank
    by_rank = sorted(ENC_MODES)
    out = []
    for k in range(3):
        r = rank[rk["l_shipmode"][rk["l_returnflag"] == k]]
        if len(r):
            out.append((ENC_FLAGS[k], by_rank[int(r.min())],
                        by_rank[int(r.max())], int(len(r))))
    return sorted(out)


def encoded_queries(paths: dict):
    """bench.py's q_agg, q_join (main_encoded) and q_sort, q_minmax
    (main_encoded_rank), over the session given."""
    from spark_rapids_tpu_torch.plan import functions as F

    li, dim, srt_path = paths["lineitem_like"], paths["modes"], \
        paths["sorted_lowcard"]

    def q_agg(s):
        return (s.read.parquet(li)
                .filter(F.col("l_returnflag") == F.lit("A"))
                .groupBy("l_linestatus", "l_shipmode")
                .agg(F.count("*").alias("n"),
                     F.sum("l_quantity").alias("qty"),
                     F.sum("l_extendedprice").alias("rev")))

    def q_join(s):
        lt, dm = s.read.parquet(li), s.read.parquet(dim)
        return (lt.join(dm, lt["l_shipmode"] == dm["m_mode"], "inner")
                .groupBy("l_returnflag")
                .agg(F.count("*").alias("n"),
                     F.sum("m_cost").alias("cost"),
                     F.max("l_comment").alias("mc")))

    def q_sort(s):
        return (s.read.parquet(srt_path)
                .groupBy("l_returnflag", "l_shipmode")
                .agg(F.sum("l_quantity").alias("qty"))
                .orderBy("l_returnflag", "l_shipmode"))

    def q_minmax(s):
        return (s.read.parquet(srt_path).groupBy("l_returnflag")
                .agg(F.min("l_shipmode").alias("mn"),
                     F.max("l_shipmode").alias("mx"),
                     F.count("*").alias("c")))

    return {"q_agg": q_agg, "q_join": q_join, "q_sort": q_sort,
            "q_minmax": q_minmax}


def tpch_dict_files(root: str, raw) -> dict:
    """Phase 4's cached SF 10 lineitem and orders written as parquet-mr
    writes them: dictionary chunks for the STRING and DATE columns (and
    o_shippriority), PLAIN for the keys and the DOUBLE columns; row groups
    of 7.5M rows, pages of 2^20."""
    import numpy as np

    from spark_rapids_tpu_torch.benchmarks import tpch

    pools = {"l_returnflag": tpch._FLAGS, "l_linestatus": tpch._STATUS,
             "l_shipmode": tpch._SHIPMODES, "l_shipinstruct": tpch._INSTRUCT,
             "o_orderpriority": tpch._PRIORITIES,
             "o_orderstatus": ["F", "O", "P"],
             "o_comment": tpch._O_COMMENTS}
    from concurrent.futures import ThreadPoolExecutor

    def spec_of(df, a):
        if a.name in pools:
            return dict_spec(
                pool_index(df, a.name, pools[a.name]).astype(np.int32),
                pool_bytes(pools[a.name]), PHYS_BYTE_ARRAY, CONV_UTF8)
        v = table_columns(df, (a.name,))[a.name]
        if a.data_type.name in ("DATE", "INT32"):
            lo, hi = int(v.min()), int(v.max()) + 1
            return dict_spec((v - lo).astype(np.int32),
                             np.arange(lo, hi, dtype=np.int32), PHYS_INT32,
                             CONV_DATE if a.data_type.name == "DATE"
                             else None)
        if v.dtype == np.float64:
            return plain_spec(v, PHYS_DOUBLE)
        return plain_spec(v.astype(np.int64), PHYS_INT64)

    t = time.perf_counter()
    paths = {}
    for name in ("lineitem", "orders"):
        df = raw[name]
        with ThreadPoolExecutor(8) as ex:
            specs = dict(zip([a.name for a in df.schema], ex.map(
                lambda a: spec_of(df, a), df.schema)))
        paths[name] = os.path.join(root, f"{name}_dict.parquet")
        write_parquet_fixture(paths[name], specs, TPCH_DICT_ROW_GROUP,
                              ENCODED_PAGE_ROWS)
    secs = time.perf_counter() - t
    log(f"encoded: TPC-H SF 10 lineitem and orders written with dictionary "
        f"chunks in {secs:.1f} s")
    return {"paths": paths, "write_s": secs}


def run_encoded_query(sess, q, want, name: str, launches: dict,
                      ordered: bool, input_rows: int) -> dict:
    """One path: a cold and ENCODED_WARM_REPS warm runs (rows against
    numpy), its launch
    counts, the encoded columns the scan emitted and the device decodes
    over the path's 4 runs, the last run's scan host seconds and the peak
    device bytes."""
    import torch

    from spark_rapids_tpu_torch import cuda_build as CB
    from spark_rapids_tpu_torch.columnar import encoded as E

    class Sorted:
        def __init__(self, q):
            self.q = q

        def collect(self):
            return sorted(self.q.collect(), key=repr)

    if not ordered:
        want = sorted(want, key=repr)
    E.reset_counters()
    CB.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    res = run_query(sess, q if ordered else Sorted(q), want, name,
                    ENCODED_WARM_REPS)
    launches[name] = CB.launch_counts()
    # above what the phase already held (phase 4's cached tables)
    res["peak_device_bytes"] = torch.cuda.max_memory_allocated() - held
    assert_file_leaves(sess)
    res.update(E.counters())
    res["scan_host_s"] = scan_host_s(sess)
    res["input_rows"] = input_rows
    res["rows_per_s"] = input_rows / best_s(res)
    res["k23_launches"] = {k: launches[name].get(k, 0) for k in (
        "dict_materialize_fixed", "dict_materialize_strings")}
    res["k24_launches"] = launches[name].get("remap_codes", 0)
    res["k4_code_launches"] = launches[name].get("hash_partition_codes", 0)
    log(f"{name}: encoded columns {res['encodedColumns']}, device decodes "
        f"{res['lateMaterializations']}, K23 {res['k23_launches']}, K24 "
        f"{res['k24_launches']}, K4 codes {res['k4_code_launches']}, peak "
        f"{res['peak_device_bytes']} B, scan host {res['scan_host_s']:.3f} s")
    return res


def run_encoded(tpch_sess, raw, wants: dict, launches: dict, root: str,
                profile_dir=None):
    """The encoded phase: bench.py --encoded's q_agg and q_join and its
    rank companion's q_sort and q_minmax at ENCODED_ROWS rows, TPC-H q1 and
    q12 over SF 10 dictionary Parquet, each with encoding on and off (the
    off run's path name ends in _off), all against numpy. Every 'on' path
    must show encoded columns from the scan; q_agg decodes no STRING column
    before the sink. Its files stay in `root` for phase 19; returns the
    results and encoded_bench_files's."""
    import numpy as np

    import spark_rapids_tpu_torch as srt
    from spark_rapids_tpu_torch.benchmarks import tpch

    out = {}
    bench = encoded_bench_files(root)
    tfiles = tpch_dict_files(root, raw)
    out["write_s"] = {"bench": bench["write_s"],
                      "tpch": tfiles["write_s"]}
    qs = encoded_queries(bench["paths"])
    wants_enc = {"q_agg": numpy_enc_agg(bench["li"]),
                 "q_join": numpy_enc_join(bench["li"]),
                 "q_sort": numpy_enc_sort(bench["rk"]),
                 "q_minmax": numpy_enc_minmax(bench["rk"])}
    n = ENCODED_ROWS
    for label, extra in (("", {}), ("_off", ENCODED_OFF)):
        for qname, qfn in qs.items():
            conf = {**TPCH_CONF, **extra,
                    **(ENC_SHUFFLED if qname == "q_join" else {})}
            sess = srt.new_session(conf)
            name = f"encoded_{qname}{label}"
            out[name] = run_encoded_query(
                sess, qfn(sess), wants_enc[qname], name, launches,
                qname == "q_sort", n + (7 if qname == "q_join" else 0))
            if profile_dir and not label and qname == "q_agg":
                out[name]["profile"] = profile_query(
                    qfn(sess), profile_dir, name)
        sess = srt.new_session({**TPCH_CONF, **extra})
        t = {k: sess.read.parquet(p) for k, p in tfiles["paths"].items()}
        rows = {"q1": wants["input_rows"]["q1"],
                "q12": wants["input_rows"]["q1"] + sum(
                    b.num_rows for part in raw["orders"]._plan.partitions
                    for b in part)}
        for q in ("q1", "q12"):
            name = f"encoded_tpch_{q}{label}"
            out[name] = run_encoded_query(
                sess, tpch.QUERIES[q](t), wants[f"tpch_{q}"], name,
                launches, True, rows[q])
            if profile_dir and not label and q == "q1":
                out[name]["profile"] = profile_query(
                    tpch.q1(t), profile_dir, name)
    for name, r in out.items():
        if not name.startswith("encoded_"):
            continue
        if name.endswith("_off"):
            check(r["encodedColumns"] == 0,
                  f"{name}: the scan emitted encoded columns with "
                  "encoding off")
        else:
            check(r["encodedColumns"] > 0,
                  f"{name}: the scan emitted no encoded column")
    check(out["encoded_q_agg"]["k23_launches"][
        "dict_materialize_strings"] == 0,
        "encoded_q_agg decoded a STRING column before the sink")
    for name in list(out):
        if name.startswith("encoded_") and not name.endswith("_off"):
            off = out[f"{name}_off"]
            out[name]["speedup_vs_off"] = best_s(off) / best_s(out[name])
            log(f"{name}: {best_s(out[name]):.4f} s on, "
                f"{best_s(off):.4f} s off")
    return out, bench


# ------------------------------------------------------- phase 19 (slice 17)
# a row group is one scan batch, so the companion's run tables reach the
# aggregate (a batch sliced below its row group is a gather, which drops
# them); the serialized tier and the injected fetch loss
RUNS_CONF = {"rapids.tpu.sql.reader.batchSizeRows": ENCODED_ROW_GROUP}
SERIALIZED = {"rapids.tpu.shuffle.serialize.enabled": True}
COMPRESSED_WARM_REPS = 1


def write_rle_companion(root: str, rk: dict) -> dict:
    """Phase 10's rank companion (seed 7, ENCODED_ROWS rows, 8 row groups)
    again with l_shipmode and l_bucket's indices as RLE runs only, as
    Spark's and Arrow's writers emit a sorted column. Each row group's
    dictionary lists its entries in pool order: l_returnflag's pool is
    reversed (R, N, A) and l_shipmode's is ENC_MODES, so the window's
    keys hold dictionaries that are not sorted and go through the rank
    remap (row group 0's first-seen flags, A, N, R, were sorted)."""
    import numpy as np

    t = time.perf_counter()
    path = os.path.join(root, "sorted_lowcard_rle.parquet")
    flags = len(ENC_FLAGS) - 1 - rk["l_returnflag"]
    write_parquet_fixture(path, {
        "l_shipmode": dict_spec(rk["l_shipmode"], pool_bytes(ENC_MODES),
                                PHYS_BYTE_ARRAY, CONV_UTF8, rle=True),
        "l_returnflag": dict_spec(flags.astype(np.int32),
                                  pool_bytes(ENC_FLAGS[::-1]),
                                  PHYS_BYTE_ARRAY, CONV_UTF8),
        "l_quantity": dict_spec((rk["l_quantity"] - 1).astype(np.int32),
                                np.arange(1, 51, dtype=np.int64),
                                PHYS_INT64),
        "l_bucket": dict_spec(rk["l_bucket"].astype(np.int32),
                              np.arange(0, 32, dtype=np.int64), PHYS_INT64,
                              rle=True)},
        ENCODED_ROW_GROUP, ENCODED_PAGE_ROWS, first_seen=False)
    return {"path": path, "write_s": time.perf_counter() - t}


def written_runs(cols, n: int, row_group: int, page_rows: int):
    """(rows the collapse removes, most merged runs in a row group) of
    columns whose every page writes one RLE run per run of equal values:
    a row group's merged runs start at its pages' first rows and wherever
    any of the columns changes."""
    import numpy as np

    collapsed, most = 0, 0
    for lo in range(0, n, row_group):
        hi = min(lo + row_group, n)
        starts = [np.arange(0, hi - lo, page_rows)]
        for c in cols:
            seg = c[lo:hi]
            starts.append(np.flatnonzero(seg[1:] != seg[:-1]) + 1)
        runs = len(np.unique(np.concatenate(starts)))
        collapsed += (hi - lo) - runs
        most = max(most, runs)
    return collapsed, most


def numpy_q_runs(rk: dict):
    """q_runs: by l_shipmode count(*), sum(l_bucket)."""
    import numpy as np

    c = np.bincount(rk["l_shipmode"], minlength=7)
    b = np.bincount(rk["l_shipmode"], rk["l_bucket"], minlength=7)
    return sorted((ENC_MODES[m], int(c[m]), int(b[m])) for m in range(7)
                  if c[m])


def bucket_lanes(n: int) -> int:
    from spark_rapids_tpu_torch.columnar.batch import bucket_capacity

    return bucket_capacity(max(n, 1))


class K48Lanes:
    """The capacity of every K48 launch while entered (ops/program.py
    calls stage_program by its module name)."""

    def __enter__(self):
        from spark_rapids_tpu_torch.ops import program as PG

        self.lanes, self._orig, self._pg = [], PG.stage_program, PG

        def recorded(prog, inputs, num_rows, capacity, device):
            self.lanes.append(int(capacity))
            return self._orig(prog, inputs, num_rows, capacity, device)

        PG.stage_program = recorded
        return self

    def __exit__(self, *exc):
        self._pg.stage_program = self._orig


def run_runs(path: str, rk: dict, launches: dict) -> dict:
    """Phase 19(a): bench.py's q_runs (`bench.py:1617`) over the RLE
    companion with runAware on and off (a cold and COMPRESSED_WARM_REPS
    warm runs each) against numpy; runCollapsedRows against the written
    runs when on and 0 when off; K48's lanes over the runs, not the rows;
    phase 10's q_sort and q_minmax over the companion against numpy."""
    import spark_rapids_tpu_torch as srt
    from spark_rapids_tpu_torch import cuda_build as CB
    from spark_rapids_tpu_torch.plan import functions as F

    want = sorted(numpy_q_runs(rk), key=repr)
    collapsed, most = written_runs([rk["l_shipmode"], rk["l_bucket"]],
                                   ENCODED_ROWS, ENCODED_ROW_GROUP,
                                   ENCODED_PAGE_ROWS)
    out = {}
    for label, on in (("", True), ("_off", False)):
        name = f"compressed_q_runs{label}"
        sess = srt.new_session({**TPCH_CONF, **RUNS_CONF,
                                "rapids.tpu.sql.runAware.enabled": on})
        q = (sess.read.parquet(path).groupBy("l_shipmode")
             .agg(F.count("*").alias("c"), F.sum("l_bucket").alias("b")))
        CB.reset_launch_counts()
        with K48Lanes() as k48:
            r = run_query(sess, q, want, name, COMPRESSED_WARM_REPS,
                          order=repr)
        launches[name] = CB.launch_counts()
        got = sess.last_query_metrics.get("runCollapsedRows", 0)
        r["runCollapsedRows"] = got
        r["k48_max_lanes"] = max(k48.lanes)
        r["input_rows"] = ENCODED_ROWS
        r["rows_per_s"] = ENCODED_ROWS / best_s(r)
        check(got == (collapsed if on else 0),
              f"{name}: runCollapsedRows {got}, the written runs give "
              f"{collapsed if on else 0}")
        out[name] = r
    on, off = out["compressed_q_runs"], out["compressed_q_runs_off"]
    # the update's K48 program runs over the merged runs: its lanes are a
    # run batch's, far below a row group's
    check(on["k48_max_lanes"] <= bucket_lanes(most) < off["k48_max_lanes"],
          f"q_runs: K48 lanes {on['k48_max_lanes']} on, "
          f"{off['k48_max_lanes']} off; most merged runs {most}")
    out["written_collapse"] = {"rows": collapsed, "most_runs": most}
    qs = encoded_queries({"lineitem_like": None, "modes": None,
                          "sorted_lowcard": path})
    sess = srt.new_session({**TPCH_CONF, **RUNS_CONF})
    for qname, want_q in (("q_sort", numpy_enc_sort(rk)),
                          ("q_minmax", numpy_enc_minmax(rk))):
        name = f"compressed_{qname}_rle"
        CB.reset_launch_counts()
        ordered = qname == "q_sort"
        out[name] = run_query(sess, qs[qname](sess), want_q if ordered
                              else sorted(want_q, key=repr), name, 0,
                              order=None if ordered else repr)
        launches[name] = CB.launch_counts()
    log(f"phase 19(a): q_runs {best_s(on):.4f} s on ({on['runCollapsedRows']}"
        f" rows collapsed, K48 lanes {on['k48_max_lanes']}), "
        f"{best_s(off):.4f} s off (K48 lanes {off['k48_max_lanes']})")
    return out


def result_columns(df):
    """(data, validity) host numpy columns of a query's result."""
    import numpy as np

    batches = [b for b in df.toLocalBatches() if b.num_rows]
    return [(np.concatenate([b.columns[i].data[:b.num_rows]
                             for b in batches]),
             np.concatenate([b.columns[i].validity[:b.num_rows]
                             for b in batches]))
            for i in range(len(df.columns))]


def check_window(cols, rk: dict, encoded: bool, what: str) -> None:
    """Phase 19(b)'s window over (l_returnflag, l_shipmode) against numpy:
    per flag, rank and dense_rank in code-point order of the modes (or,
    with encoding off, where STRING keys order by their hash words, the
    partition's row count and the multiset of dense ranks); row_number a
    permutation of the partition within each tie; lag(l_quantity) the
    previous row's by row_number. Sorts and counts as torch ops on the
    card."""
    import numpy as np
    import torch

    dev = torch.device("cuda", 0) if torch.cuda.is_available() else \
        torch.device("cpu")
    (fa, _), (fn, _), (q, _), (rk_, _), (dr, _), (rn, _), (lg, lgv) = cols
    flag = torch.from_numpy(np.where(fa, 0, np.where(fn, 1, 2))).to(dev)
    q, rk_, dr, rn, lg, lgv = (torch.from_numpy(np.ascontiguousarray(x)).to(
        dev).long() for x in (q, rk_, dr, rn, lg, lgv))
    cnt = np.bincount(rk["l_returnflag"].astype(np.int64) * 7 +
                      rk["l_shipmode"], minlength=21).reshape(3, 7)
    by_name = np.argsort(np.array(ENC_MODES))   # code-point order
    for f in range(3):
        m = flag == f
        n = int(cnt[f].sum())
        check(int(m.sum()) == n, f"{what}: flag {ENC_FLAGS[f]} holds "
              f"{int(m.sum())} rows, numpy {n}")
        c = cnt[f][by_name]
        c = c[c > 0]
        got_dr = torch.bincount(dr[m], minlength=len(c) + 1).cpu().numpy()
        if not encoded:
            check(sorted(got_dr[1:].tolist()) == sorted(c.tolist()),
                  f"{what}: flag {ENC_FLAGS[f]}'s dense ranks")
            continue
        check(got_dr[1:].tolist() == c.tolist() and got_dr[0] == 0,
              f"{what}: flag {ENC_FLAGS[f]}'s dense ranks "
              f"{got_dr[1:].tolist()}, numpy {c.tolist()}")
        first = np.concatenate([[1], 1 + np.cumsum(c)[:-1]])
        want_rank = torch.from_numpy(first).to(dev)[dr[m] - 1]
        check(bool((rk_[m] == want_rank).all()),
              f"{what}: flag {ENC_FLAGS[f]}'s ranks")
        size = torch.from_numpy(c).to(dev)[dr[m] - 1]
        r = rn[m]
        check(bool(((r >= want_rank) & (r < want_rank + size)).all()),
              f"{what}: a row_number outside its tie")
        order = torch.argsort(r)
        check(bool((r[order] == torch.arange(1, n + 1, device=dev)).all()),
              f"{what}: flag {ENC_FLAGS[f]}'s row_numbers are no "
              "permutation")
        qs, lgs, lvs = q[m][order], lg[m][order], lgv[m][order]
        check(not bool(lvs[0]) and bool(lvs[1:].all()) and
              bool((lgs[1:] == qs[:-1]).all()),
              f"{what}: lag(l_quantity) is not the previous row's")


def run_window_rank_space(path: str, rk: dict, launches: dict) -> dict:
    """Phase 19(b): Window.partitionBy(l_returnflag).orderBy(l_shipmode)
    with rank, dense_rank, row_number and lag(l_quantity) over the RLE
    companion, encoding on (rank space) and off, checked by check_window;
    orderPreservingSorts one a window batch, K24 remapping a key to rank
    space (its launches inside to_rank_space counted apart from the
    dictionary alignment's), no K5 / K6 string words."""
    import spark_rapids_tpu_torch as srt
    from spark_rapids_tpu_torch import cuda_build as CB
    from spark_rapids_tpu_torch.columnar import encoded as E
    from spark_rapids_tpu_torch.exec.base import NUM_OUTPUT_BATCHES
    from spark_rapids_tpu_torch.exec.window import TpuWindowExec
    from spark_rapids_tpu_torch.plan import functions as F
    from spark_rapids_tpu_torch.plan.window_api import Window

    out = {}
    for label, extra in (("", {}), ("_off", ENCODED_OFF)):
        name = f"compressed_window{label}"
        sess = srt.new_session({**TPCH_CONF, **extra})
        w = Window.partitionBy("l_returnflag").orderBy("l_shipmode")
        df = sess.read.parquet(path).select(
            (F.col("l_returnflag") == F.lit("A")).alias("fa"),
            (F.col("l_returnflag") == F.lit("N")).alias("fn"),
            "l_quantity", F.rank().over(w).alias("rk"),
            F.dense_rank().over(w).alias("dr"),
            F.row_number().over(w).alias("rn"),
            F.lag("l_quantity").over(w).alias("lg"))
        rank_remaps = [0, 0]     # calls, K24 launches inside them
        orig = E.to_rank_space

        def counted(cv, _orig=orig):
            before = CB.launch_counts().get("remap_codes", 0)
            got = _orig(cv)
            rank_remaps[0] += 1
            rank_remaps[1] += CB.launch_counts().get("remap_codes", 0) - \
                before
            return got

        E.to_rank_space = counted
        CB.reset_launch_counts()
        try:
            import torch

            torch.cuda.synchronize()
            t = time.perf_counter()
            cols = result_columns(df)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
        finally:
            E.to_rank_space = orig
        launches[name] = CB.launch_counts()
        assert_on_device(sess)
        ops = sess.last_query_metrics.get("orderPreservingSorts", 0)
        win = sess.last_physical_plan.collect_nodes(
            lambda n: isinstance(n, TpuWindowExec))
        batches = sum(n.metrics[NUM_OUTPUT_BATCHES] for n in win)
        t = time.perf_counter()
        check_window(cols, rk, not extra, name)
        out[name] = {"cold_s": secs, "warm_s": [], "warm_median_s": None,
                     "rows": len(cols[0][0]), "input_rows": ENCODED_ROWS,
                     "orderPreservingSorts": ops, "window_batches": batches,
                     "rank_remaps": rank_remaps[0],
                     "k24_rank_launches": rank_remaps[1],
                     "k24_launches": launches[name].get("remap_codes", 0),
                     "check_s": time.perf_counter() - t}
        words = {k: launches[name].get(k, 0) for k in (
            "string_hash_words", "string_order_words")}
        if not extra:
            check(batches > 0 and ops >= batches,
                  f"{name}: orderPreservingSorts {ops} over {batches} "
                  "window batches")
            check(rank_remaps[0] > 0 and rank_remaps[1] > 0,
                  f"{name}: {rank_remaps[0]} rank remaps launched K24 "
                  f"{rank_remaps[1]} times")
            check(not any(words.values()),
                  f"{name}: the window's keys made string words {words}")
        else:
            check(ops == 0, f"{name}: orderPreservingSorts {ops} with "
                  "encoding off")
        log(f"{name}: {secs:.4f} s, orderPreservingSorts {ops} over "
            f"{batches} batches, rank remaps {rank_remaps[0]} (K24 "
            f"{rank_remaps[1]}), K24 in all {out[name]['k24_launches']}, "
            f"string words {words}, check "
            f"{out[name]['check_s']:.1f} s")
    return out


def serialized_bytes():
    """Wrap serde.serialize_batch (the exchange looks it up at each call)
    to count bench.py:1447-1551's two figures: every serialized byte, and
    the bytes of the STRING and dictionary columns (codes, the pruned
    dictionary's offsets and bytes; offsets and value bytes)."""
    import numpy as np

    from spark_rapids_tpu_torch.columnar import encoded as E
    from spark_rapids_tpu_torch.columnar import serde
    from spark_rapids_tpu_torch.columnar.dtypes import DataType

    counts = [0, 0]
    orig = serde.serialize_batch

    def col_bytes(batch) -> int:
        tot, n = 0, batch.num_rows
        for c in batch.columns:
            if isinstance(c, E.HostDictionaryColumn):
                used = np.unique(c.data[:n][c.validity[:n]])
                tot += 4 * n + 4 + 4 * (len(used) + 1) + int(
                    c.dictionary.host_lens[used].sum())
            elif c.dtype is DataType.STRING:
                offs, _ = c.utf8()
                lens = np.diff(offs[:n + 1].astype(np.int64))
                tot += 4 * (n + 1) + int(lens[c.validity[:n]].sum())
        return tot

    def counting(batch):
        data = orig(batch)
        counts[0] += len(data)
        counts[1] += col_bytes(batch)
        return data

    serde.serialize_batch = counting
    return counts, lambda: setattr(serde, "serialize_batch", orig)


def run_serialized(tpch_sess, tables, wants: dict, bench: dict,
                   launches: dict) -> dict:
    """Phase 19(c): phase 10's q_join (shuffled) with encoding on and off
    and q_sort, and TPC-H q5 over phase 4's cached tables, each first
    unserialized and then with shuffle.serialize.enabled in one session,
    a cold and COMPRESSED_WARM_REPS warm runs each: rows against numpy;
    the serialized bytes of a run (bench.py's count) and the host store's
    bytes; the join's bytes fewer encoded than decoded; then q_sort with
    one injected shuffle.fetch loss, whose map partition runs again
    (fetchRetries 1, equal rows)."""
    import spark_rapids_tpu_torch as srt
    from spark_rapids_tpu_torch import cuda_build as CB
    from spark_rapids_tpu_torch.benchmarks import tpch
    from spark_rapids_tpu_torch.memory.spill import SpillFramework
    from spark_rapids_tpu_torch.shuffle import exchange as EX
    from spark_rapids_tpu_torch.utils import faultinject as FI

    qs = encoded_queries(bench["paths"])
    wants_enc = {"q_join": numpy_enc_join(bench["li"]),
                 "q_sort": numpy_enc_sort(bench["rk"])}
    counts, restore = serialized_bytes()
    stored = [0]
    orig_add = SpillFramework.add_host_bytes

    def add_host_bytes(self, data, *a, **kw):
        stored[0] += len(data)
        return orig_add(self, data, *a, **kw)

    SpillFramework.add_host_bytes = add_host_bytes
    key = "rapids.tpu.shuffle.serialize.enabled"
    out = {}

    def one(name, sess, q, want, ordered, reps=COMPRESSED_WARM_REPS):
        """The path unserialized (its time only, unless reps is None: the
        fault run has no counterpart), then serialized."""
        want = want if ordered else sorted(want, key=repr)
        order = None if ordered else repr
        base = None
        if reps is not None:
            sess.set_conf(key, False)
            base = run_query(sess, q(sess), want, f"{name} unserialized",
                             reps, order=order)
        sess.set_conf(key, True)
        counts[0] = counts[1] = stored[0] = 0
        CB.reset_launch_counts()
        r = run_query(sess, q(sess), want, name, reps or 0, order=order)
        launches[name] = CB.launch_counts()
        runs = 1 + len(r["warm_s"])
        r.update({"serialized_bytes": counts[0] // runs,
                  "serialized_string_col_bytes": counts[1] // runs,
                  "host_store_bytes": stored[0] // runs,
                  "fetchRetries": sess.last_query_metrics.get(
                      "fetchRetries", 0),
                  "unserialized_s": None if base is None else best_s(base)})
        check(counts[0] > 0 and stored[0] == counts[0],
              f"{name}: serialized {counts[0]} B, host store {stored[0]} B")
        log(f"{name}: {best_s(r):.4f} s serialized, "
            f"{r['unserialized_s']} s not; {r['serialized_bytes']} B a run "
            f"({r['serialized_string_col_bytes']} B string / dictionary "
            "columns)")
        out[name] = r
        return r

    try:
        for label, extra in (("", {}), ("_off", ENCODED_OFF)):
            sess = srt.new_session({**TPCH_CONF, **ENC_SHUFFLED, **extra})
            one(f"serialized_q_join{label}", sess, qs["q_join"],
                wants_enc["q_join"], False)
        check(out["serialized_q_join"]["serialized_bytes"] <
              out["serialized_q_join_off"]["serialized_bytes"],
              "serialized q_join: encoded bytes not below decoded")
        sess = srt.new_session(TPCH_CONF)
        one("serialized_q_sort", sess, qs["q_sort"], wants_enc["q_sort"],
            True)
        try:
            one("serialized_tpch_q5", tpch_sess, lambda _s: tpch.q5(tables),
                wants["tpch_q5"], True)
        finally:
            tpch_sess.set_conf(key, False)
        # one lost piece: count q_sort's reads, pick a seed that loses one
        reads = [0]
        orig_decode = EX._SerializedPiece.decode

        def counted(self, device):
            reads[0] += 1
            return orig_decode(self, device)

        EX._SerializedPiece.decode = counted
        try:
            sess.last_query_metrics = {}
            qs["q_sort"](sess).collect()
        finally:
            EX._SerializedPiece.decode = orig_decode
        rate = 1.0 / (reads[0] + 1)
        seed = FI.one_loss_seed("shuffle.fetch", reads[0], rate)
        sess = srt.new_session({
            **TPCH_CONF, **SERIALIZED,
            "rapids.tpu.test.faultInjection.enabled": True,
            "rapids.tpu.test.faultInjection.sites": "shuffle.fetch",
            "rapids.tpu.test.faultInjection.seed": seed,
            "rapids.tpu.test.faultInjection.rate": rate})
        r = one("serialized_q_sort_fetch_loss", sess, qs["q_sort"],
                wants_enc["q_sort"], True, reps=None)
        check(r["fetchRetries"] == 1,
              f"q_sort with one lost piece: fetchRetries {r['fetchRetries']}")
        r["reads"] = reads[0]
    finally:
        restore()
        SpillFramework.add_host_bytes = orig_add
    return out


def run_compressed(tpch_sess, tables, wants: dict, bench: dict, root: str,
                   launches: dict) -> dict:
    """Phase 19 (after phase 10, on its files and phase 4's cached
    tables): (a) run_runs, (b) run_window_rank_space, (c)
    run_serialized."""
    t0 = time.perf_counter()
    comp = write_rle_companion(root, bench["rk"])
    log(f"phase 19: RLE companion written in {comp['write_s']:.1f} s")
    out = {"write_s": comp["write_s"]}
    out.update(run_runs(comp["path"], bench["rk"], launches))
    out.update(run_window_rank_space(comp["path"], bench["rk"], launches))
    out.update(run_serialized(tpch_sess, tables, wants, bench, launches))
    out["phase_s"] = time.perf_counter() - t0
    log(f"phase 19: {out['phase_s']:.1f} s")
    return out


# ------------------------------------------- encoded kernels (phase 3 part)
def _enc_dicts():
    import numpy as np

    from spark_rapids_tpu_torch.columnar import encoded as E
    from spark_rapids_tpu_torch.columnar.dtypes import DataType

    return {
        "STRING": E.DeviceDictionary.from_values(
            ["", "AIR", "é", "日本語", "REG AIR", "x" * 70, "MAIL"]),
        "INT64": E.DeviceDictionary.from_fixed_values(
            np.array([5, -(1 << 40), 7, 1 << 33, 0], np.int64),
            DataType.INT64),
        "DATE": E.DeviceDictionary.from_fixed_values(
            np.array([8035, 10591, -3, 9000], np.int32), DataType.DATE),
        "ONE": E.DeviceDictionary.from_values(["only"]),
    }


def _codes_for(rng, n: int, ndv: int, null_frac: float, dev):
    import numpy as np
    import torch

    codes = rng.integers(0, max(ndv, 1), n).astype(np.int32)
    if n >= 4:
        codes[:4] = [0, max(ndv - 1, 0), ndv, -1]  # last entry, overruns
    valid = rng.random(n) >= null_frac
    return torch.as_tensor(codes).to(dev), torch.as_tensor(valid).to(dev)


def _same(got, want, label: str, errs: dict, name: str) -> None:
    import torch

    got, want = got.cpu(), want.cpu()
    check(got.dtype == want.dtype and torch.equal(got, want),
          f"{label}: kernel differs from its plain version")
    errs[name] = max(errs.get(name, 0.0), max_abs_err(got, want))


def encoded_edge_cases(dev, errs: dict) -> int:
    """K21 codes, K23 fixed and string, K24 in both fills and K4's code
    mode bit for bit against their plain versions: an all-NULL chunk, a
    required column, ndv = 1, codes equal to ndv - 1 and past the table,
    an empty batch, a dictionary holding "" and multi-byte UTF-8, an
    absent value, one stream dictionary against two build dictionaries;
    K4's code mode also against K4 over the expanded values."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.columnar import encoded as E
    from spark_rapids_tpu_torch.io import parquet_device as PD
    from spark_rapids_tpu_torch.ops import hashing as H
    from spark_rapids_tpu_torch.ops.eval import col_to_colv

    rng = np.random.default_rng(8)
    cases = 0
    cpu = torch.device("cpu")
    # K21 codes: levels with NULLs, all NULL, none (required), ndv = 1
    for n, null_frac, ndv in ((1000, 0.3, 200), (777, 1.0, 5),
                              (513, None, 1), (0, 0.0, 3)):
        cap = max(8, 1 << max(n, 1).bit_length())
        valid = rng.random(n) >= (null_frac or 0.0)
        levels = None
        if null_frac is not None:
            lv = np.zeros(cap, np.int32)
            lv[:n] = valid
            levels = torch.as_tensor(lv)
        k = int(valid.sum()) if null_frac is not None else n
        idx = torch.as_tensor(rng.integers(0, ndv, max(k, 1)).astype(
            np.int32))
        got = PD.page_decode_codes(None if levels is None else levels.to(dev),
                                   n, cap, idx.to(dev))
        want = PD.page_decode_codes(levels, n, cap, idx)
        _same(got, want, f"K21 codes {n} rows", errs, "page_decode_codes")
        cases += 1
    d = _enc_dicts()
    for kind in ("STRING", "INT64", "DATE", "ONE"):
        dd = d[kind]
        for n in (0, 1, 300):
            codes, valid = _codes_for(rng, n, dd.size, 0.2, dev)
            if dd.is_fixed:
                got = E.dict_materialize_fixed(codes, valid,
                                               dd.device_fixed_values(dev))
                want = E.dict_materialize_fixed(codes.cpu(), valid.cpu(),
                                                dd.device_fixed_values(cpu))
                _same(got, want, f"K23 fixed {kind} {n}", errs,
                      "dict_materialize_fixed")
            else:
                _b, offs = dd.device_strings(dev)
                got = E.dict_materialize_spans(codes, valid, offs)
                want = E.dict_materialize_spans(codes.cpu(), valid.cpu(),
                                                offs.cpu())
                for g, w in zip(got, want):
                    _same(g, w, f"K23 spans {kind} {n}", errs,
                          "dict_materialize_strings")
                col = E.DictionaryColumn(dd.value_dtype, codes, valid, dd)
                m = E.materialize(col)
                mc = E.materialize(E.DictionaryColumn(
                    dd.value_dtype, codes.cpu(), valid.cpu(), dd))
                _same(m.offsets, mc.offsets, f"K23 offsets {kind} {n}",
                      errs, "dict_materialize_strings")
                total = int(mc.offsets[-1])
                _same(m.data[:total], mc.data[:total],
                      f"K23 bytes {kind} {n}", errs,
                      "dict_materialize_strings")
            cases += 1
    # K24: both fills, an absent value (-1), an empty batch / table, and one
    # stream dictionary against two build dictionaries
    stream = E.DeviceDictionary.from_values(["open", "closed", "pending"])
    builds = [E.DeviceDictionary.from_values(["closed", "open"]),
              E.DeviceDictionary.from_values(["pending", "archived", "open",
                                              "closed"])]
    for b in builds:
        remap = torch.as_tensor(E.join_remap(stream, b))
        for n in (0, 500):
            codes, valid = _codes_for(rng, n, stream.size, 0.1, dev)
            for fill in (0, -1):
                got = E.remap_codes(codes, valid, remap.to(dev), fill)
                want = E.remap_codes(codes.cpu(), valid.cpu(), remap, fill)
                _same(got, want, f"K24 fill {fill} {n}", errs,
                      "remap_codes")
                cases += 1
    empty = torch.zeros(0, dtype=torch.int32)
    codes, valid = _codes_for(rng, 64, 3, 0.1, dev)
    _same(E.remap_codes(codes, valid, empty.to(dev), -1),
          E.remap_codes(codes.cpu(), valid.cpu(), empty, -1),
          "K24 empty table", errs, "remap_codes")
    check(stream.code_of("absent") == -1, "an absent literal has a code")
    # K4 code mode: against its plain version and K4 over the values
    for kind in ("STRING", "INT64", "DATE", "ONE"):
        dd = d[kind]
        for parts in (8, 5000):
            codes, valid = _codes_for(rng, 1000, dd.size, 0.15, dev)
            codes = torch.where(valid, codes.clamp(0, dd.size - 1),
                                torch.zeros_like(codes))
            col = E.DictionaryColumn(dd.value_dtype, codes, valid, dd)
            live = torch.arange(1000, device=dev) < 990
            ids, counts = H.partition_ids([E.code_key(col)], live, parts)
            ccol = E.DictionaryColumn(dd.value_dtype, codes.cpu(),
                                      valid.cpu(), dd)
            pids, pcounts = H.partition_ids([E.code_key(ccol)], live.cpu(),
                                            parts)
            _same(ids, pids, f"K4 codes {kind} {parts}", errs,
                  "hash_partition_codes")
            _same(counts, pcounts, f"K4 codes counts {kind} {parts}", errs,
                  "hash_partition_codes")
            vids, _ = H.partition_ids([col_to_colv(E.materialize(col))],
                                      live, parts)
            _same(ids, vids, f"K4 codes vs values {kind} {parts}", errs,
                  "hash_partition_codes")
            cases += 1
    return cases


def time_encoded_kernels(dev, errs: dict) -> dict:
    """K21 codes, K23, K24 and K4's code mode at one row group of the
    encoded bench table (7.5M rows): l_comment's 200-string dictionary for
    K23 string mode, l_extendedprice's INT64 values for K23 fixed; each
    against its plain version (bit for bit) and timed with CUDA events."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.columnar import encoded as E
    from spark_rapids_tpu_torch.columnar.batch import bucket_capacity
    from spark_rapids_tpu_torch.columnar.dtypes import DataType
    from spark_rapids_tpu_torch.io import parquet_device as PD
    from spark_rapids_tpu_torch.ops import hashing as H

    n = ENCODED_ROW_GROUP
    cap = bucket_capacity(n)
    iters, plain_iters = KERNEL_ITERS, PLAIN_ITERS
    rng = np.random.default_rng(9)
    rows = {}
    valid_np = rng.random(n) >= 0.01
    levels = torch.zeros(cap, dtype=torch.int32, device=dev)
    levels[:n] = torch.as_tensor(valid_np.astype(np.int32)).to(dev)
    k = int(valid_np.sum())
    idx = torch.as_tensor(rng.integers(0, 200, k).astype(np.int32)).to(dev)
    got = PD.page_decode_codes(levels, n, cap, idx)
    _same(got, PD.page_decode_codes(levels.cpu(), n, cap, idx.cpu()),
          "K21 codes 7.5M", errs, "page_decode_codes")
    rows["page_decode_codes"] = dict(
        ms=cuda_ms(lambda: PD.page_decode_codes(levels, n, cap, idx), iters),
        plain_ms=cuda_ms(lambda: PD.page_decode_codes_plain(
            levels, n, cap, idx), plain_iters),
        library_ms=None,
        bound_ms=bound_ms(4 * n + 4 * k + 4 * cap),
        shape=f"{n} rows, 1% NULL, 200-entry dictionary")
    codes = got
    valid = torch.zeros(cap, dtype=torch.bool, device=dev)
    valid[:n] = levels[:n] != 0
    comments = E.DeviceDictionary.from_values(ENC_COMMENTS)
    byts, offs = comments.device_strings(dev)
    starts, lens = E.dict_materialize_spans(codes, valid, offs)
    pstarts, plens = E.dict_materialize_spans_plain(codes, valid, offs)
    _same(starts, pstarts, "K23 spans 7.5M", errs, "dict_materialize_strings")
    _same(lens, plens, "K23 lens 7.5M", errs, "dict_materialize_strings")
    col = E.DictionaryColumn(comments.value_dtype, codes, valid, comments)
    total = int(lens.sum())
    rows["dict_materialize_strings"] = dict(
        ms=cuda_ms(lambda: E.dict_materialize_spans(codes, valid, offs),
                   iters),
        plain_ms=cuda_ms(lambda: E.dict_materialize_spans_plain(
            codes, valid, offs), plain_iters),
        library_ms=None,
        bound_ms=bound_ms(5 * cap + 12 * cap),
        ms_with_span_copy=cuda_ms(lambda: E.materialize(col), iters),
        bound_ms_with_span_copy=bound_ms(5 * cap + 4 * cap + total + cap),
        shape=f"{cap} lanes of l_comment codes ({total} bytes materialized)")
    prices = E.DeviceDictionary.from_fixed_values(
        np.arange(100, 100_000, dtype=np.int64), DataType.INT64)
    vals = prices.device_fixed_values(dev)
    pcodes = torch.as_tensor(rng.integers(0, prices.size, cap).astype(
        np.int32)).to(dev)
    got = E.dict_materialize_fixed(pcodes, valid, vals)
    _same(got, E.dict_materialize_fixed_plain(pcodes, valid, vals),
          "K23 fixed 7.5M", errs, "dict_materialize_fixed")
    rows["dict_materialize_fixed"] = dict(
        ms=cuda_ms(lambda: E.dict_materialize_fixed(pcodes, valid, vals),
                   iters),
        plain_ms=cuda_ms(lambda: E.dict_materialize_fixed_plain(
            pcodes, valid, vals), plain_iters),
        library_ms=cuda_ms(lambda: vals[pcodes], plain_iters),
        bound_ms=bound_ms(5 * cap + 8 * cap + 8 * prices.size),
        shape=f"{cap} lanes through {prices.size} INT64 values")
    remap = torch.as_tensor(rng.permutation(200).astype(np.int32)).to(dev)
    for fill in (0, -1):
        _same(E.remap_codes(codes, valid, remap, fill),
              E.remap_codes_plain(codes, valid, remap, fill),
              f"K24 fill {fill} 7.5M", errs, "remap_codes")
    rows["remap_codes"] = dict(
        ms=cuda_ms(lambda: E.remap_codes(codes, valid, remap, 0), iters),
        plain_ms=cuda_ms(lambda: E.remap_codes_plain(codes, valid, remap, 0),
                         plain_iters),
        library_ms=cuda_ms(lambda: remap[codes], plain_iters),
        bound_ms=bound_ms(9 * cap + 4 * 200),
        ms_join_fill=cuda_ms(lambda: E.remap_codes(codes, valid, remap, -1),
                             iters),
        shape=f"{cap} lanes, 200-entry remap")
    key = E.code_key(col)
    live = torch.arange(cap, device=dev) < n
    ids, _ = H.partition_ids([key], live, 8)
    pids, _ = H.partition_ids_plain([key], live, 8)
    _same(ids, pids, "K4 codes 7.5M", errs, "hash_partition_codes")
    rows["hash_partition_codes"] = dict(
        ms=cuda_ms(lambda: H.partition_ids([key], live, 8), iters),
        plain_ms=cuda_ms(lambda: H.partition_ids_plain([key], live, 8),
                         plain_iters),
        library_ms=None,
        bound_ms=bound_ms(6 * cap + 4 * cap + 12 * 200 + 36),
        shape=f"1 STRING code key x {cap} lanes, 8 partitions")
    return rows


# ----------------------------------------------------------------- main
# ------------------------------------------------------------ Parquet v2
V2_ROW_GROUP = 1 << 20
V2_PAGE_ROWS = 1 << 17


def compare_k25(chunk, st, out_len: int, label: str, errs: dict, want=None):
    """K25 against its plain version (and `want`, int64 numpy, when
    given), bit for bit."""
    import numpy as np

    from spark_rapids_tpu_torch.io import parquet_device as PD

    got = PD.delta_expand(chunk, st, out_len)
    plain = PD.delta_expand_plain(chunk, st, out_len)
    check(bits_equal(got, plain), f"{label}: K25 differs from its plain version")
    if want is not None:
        check(np.array_equal(got.cpu().numpy(), want),
              f"{label}: K25 differs from the encoded values")
    errs["delta_expand"] = max(errs.get("delta_expand", 0.0),
                               max_abs_err(got, plain))
    return got


def compare_k21_pages(levels, num_rows: int, cap: int, source, in_w: int,
                      out_dtype, sign: bool, label: str, errs: dict):
    import torch

    from spark_rapids_tpu_torch.io import parquet_device as PD

    got = PD.page_decode_pages(levels, num_rows, cap, source, in_w,
                               out_dtype, sign)
    want = PD.page_decode_pages_plain(levels, num_rows, cap, source, in_w,
                                      out_dtype, sign)
    check(torch.equal(got[1], want[1]), f"{label}: K21 validity differs")
    check(bits_equal(got[0], want[0]), f"{label}: K21 values differ")
    name = source.label
    errs[name] = max(errs.get(name, 0.0), max_abs_err(
        got[0].view(torch.uint8), want[0].view(torch.uint8)))
    return got


def compare_k26(chunk, plen, slen, page_lanes, base, end, label: str,
                errs: dict):
    import torch

    from spark_rapids_tpu_torch.io import parquet_device as PD

    got = PD.delta_byte_array(chunk, plen, slen, page_lanes, base, end, label)
    want = PD.delta_byte_array_plain(chunk, plen, slen, page_lanes, base,
                                     end, label)
    check(torch.equal(got[1], want[1]), f"{label}: K26 offsets differ")
    check(torch.equal(got[0], want[0]), f"{label}: K26 bytes differ")
    errs["delta_byte_array"] = max(errs.get("delta_byte_array", 0.0),
                                   max_abs_err(got[0], want[0]))
    return got


def delta_pages(pages, dev):
    """(chunk on dev, K25 streams, expected int64 lanes) of DELTA streams
    laid end to end, each at its own dense offset."""
    import numpy as np

    from spark_rapids_tpu_torch import native
    from spark_rapids_tpu_torch.io import parquet_device as PD

    raw, streams, want, lane = bytearray(b"\x07" * 3), [], [], 0
    for vals in pages:
        pos = len(raw)
        raw += delta_encode(vals)
        first, vpm, off, w, md, _ = native.parse_delta(bytes(raw), pos,
                                                       len(raw), len(vals))
        streams.append((lane, len(vals), first, vpm, off, w, md))
        want.append(np.asarray(vals).astype(np.int64))
        lane += len(vals)
    chunk = __import__("torch").from_numpy(np.frombuffer(
        bytes(raw), np.uint8).copy()).to(dev)
    return chunk, PD.delta_streams(streams, dev), np.concatenate(want), lane


def width_stream(rng, w: int, n: int):
    """n int64 values whose deltas need exactly w bits in every block."""
    import numpy as np

    if w == 0:
        return np.full(n, 123456789, np.int64)
    hi = np.uint64(1) << np.uint64(w - 1) if w < 64 else np.uint64(1 << 63)
    d = rng.integers(0, 2 ** min(w, 63), n, dtype=np.uint64) if w < 64 \
        else rng.integers(0, 2 ** 63, n, dtype=np.uint64) * np.uint64(2) + \
        rng.integers(0, 2, n, dtype=np.uint64)
    d[::16] |= hi                            # the top bit in every block
    d[1::16] = 0                             # and the least delta 0
    return np.cumsum(d).view(np.int64)


def dba_pages(pages, dev):
    """(chunk, plen, slen, page lanes, suffix starts, page ends) of
    DELTA_BYTE_ARRAY pages built from lists of byte strings."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch import native
    from spark_rapids_tpu_torch.io import parquet_device as PD

    raw, plens, slens, base, end, lanes, pres = bytearray(b"\x01"), [], \
        [], [], [], [0], 0
    for strs in pages:
        lens = np.asarray([len(x) for x in strs], np.int64)
        offs = np.zeros(len(strs) + 1, np.int64)
        np.cumsum(lens, out=offs[1:])
        pos = len(raw)
        raw += dba_encode(offs, np.frombuffer(b"".join(strs), np.uint8))
        n = len(strs)
        buf = bytes(raw)
        f1, v1, o1, w1, m1, p1 = native.parse_delta(buf, pos, len(buf), n)
        f2, v2, o2, w2, m2, p2 = native.parse_delta(buf, p1, len(buf), n)
        plens.append((pres, n, f1, v1, o1, w1, m1))
        slens.append((pres, n, f2, v2, o2, w2, m2))
        base.append(p2)
        end.append(len(buf))
        pres += n
        lanes.append(pres)
    fixed = plens + [(s[0] + pres,) + s[1:] for s in slens]
    chunk = torch.from_numpy(np.frombuffer(bytes(raw), np.uint8).copy()).to(
        dev)
    out = PD.delta_expand(chunk, PD.delta_streams(fixed, dev), 2 * pres)
    return chunk, out[:pres], out[pres:], np.asarray(lanes), \
        np.asarray(base), np.asarray(end)


def parquet_v2_edge_cases(dev, errs: dict) -> int:
    """K25, K26 and K21's BSS and FLBA modes against their plain versions,
    bit for bit (K25 also against the encoded values): empty and one-value
    streams, width 0 and every width 57-64, full-range int64 deltas,
    several streams in one launch; BSS over FLOAT / DOUBLE / INT32 / INT64
    pages of 0, 1 and many values with NULL rows; FLBA of 1-16 bytes with
    negatives and NULLs, and a dictionary page folded; DBA pages of 0 and 1
    strings, empty strings, and prefixes that chain across 3000 strings;
    then whole v2 chunks written by write_parquet_fixture (NULLs, a mixed
    dictionary -> DELTA chunk and a dictionary -> PLAIN one) decoded on the
    card against the same decode of CPU tensors."""
    import tempfile

    import numpy as np
    import torch

    from spark_rapids_tpu_torch.io import parquet_device as PD
    from spark_rapids_tpu_torch.io.parquet_meta import (
        read_chunk,
        read_footer,
    )

    rng = np.random.default_rng(91)
    n_cases = 0
    # K25
    big = rng.integers(-2**63, 2**63 - 1, 700, dtype=np.int64)
    streams = [np.zeros(0, np.int64), np.asarray([-5], np.int64), big,
               np.arange(1000, dtype=np.int64), width_stream(rng, 0, 300)] + \
        [width_stream(rng, w, 333) for w in range(57, 65)] + \
        [rng.integers(-1000, 1000, 4097).astype(np.int64)]
    chunk, st, want, lanes = delta_pages(streams, dev)
    compare_k25(chunk, st, lanes, "K25 edge streams", errs, want)
    for one in streams:
        chunk, st, want, lanes = delta_pages([one], dev)
        compare_k25(chunk, st, lanes, f"K25 {len(one)} values", errs, want)
        n_cases += 1
    # K25 across tiles: one stream of 3 tiles and a head inside a tile
    long = [rng.integers(-2**40, 2**40, 9000).astype(np.int64),
            rng.integers(0, 7, 5000).astype(np.int64)]
    chunk, st, want, lanes = delta_pages(long, dev)
    compare_k25(chunk, st, lanes, "K25 across tiles", errs, want)
    # K21 BSS and FLBA through a page table, with NULL rows
    for np_t, in_w, out_t in ((np.float32, 4, torch.float32),
                              (np.float64, 8, torch.float64),
                              (np.int32, 4, torch.int32),
                              (np.int64, 8, torch.int64)):
        for counts in ((0,), (1,), (1000, 0, 1, 333)):
            raw, ends, pos, p = bytearray(b"\x09" * 5), [], [], 0
            for c in counts:
                vals = (rng.standard_normal(c) * 1e6).astype(np_t)
                pos.append(len(raw))
                raw += bss_encode(vals)
                p += c
                ends.append(p)
            rows = p + p // 3 + 1
            lv = np.zeros(rows, bool)
            lv[np.sort(rng.choice(rows, p, replace=False))] = True
            levels = torch.from_numpy(lv.astype(np.int32)).to(dev)
            cap = 1 << max(rows - 1, 1).bit_length()
            levels = torch.cat([levels, torch.zeros(cap - rows,
                                                    dtype=torch.int32,
                                                    device=dev)])
            src = torch.from_numpy(np.frombuffer(bytes(raw), np.uint8).copy()
                                   ).to(dev)
            source = PD.page_source(src, [PD.KIND_BSS] * len(counts), ends,
                                    pos)
            compare_k21_pages(levels, rows, cap, source, in_w, out_t, False,
                              f"K21 BSS {np_t.__name__} {counts}", errs)
            n_cases += 1
    for w in range(1, 17):
        lo = -(1 << min(8 * w - 1, 62))
        vals = rng.integers(lo, -lo, 500, dtype=np.int64)
        vals[:4] = [lo, -lo - 1, -1, 0]
        raw = b"\x05\x06" + flba_encode(vals[:300], w) + b"\x07" + \
            flba_encode(vals[300:], w)
        src = torch.from_numpy(np.frombuffer(raw, np.uint8).copy()).to(dev)
        lv = rng.random(1024) < 0.8
        lv[np.flatnonzero(lv)[500:]] = False
        levels = torch.from_numpy(lv.astype(np.int32)).to(dev)
        source = PD.page_source(src, [PD.KIND_FLBA] * 2, [300, 500],
                                [2, 3 + 300 * w])
        got = compare_k21_pages(levels, 600, 1024, source, w, torch.int64,
                                w < 8, f"K21 FLBA {w} bytes", errs)
        dense = got[0][:600].cpu().numpy()[lv[:600]]
        check(np.array_equal(dense, vals[:int(lv[:600].sum())]),
              f"K21 FLBA {w} bytes: values differ from the encoded ones")
        n_cases += 1
    # K26
    chain = [b"x" * i for i in range(3000)]
    words = [b"", b"a", b"ab", b"abc", b"abd", b"b", "h\xc3\xa9".encode(),
             b"", b"zz" * 40, b"zz" * 41]
    pages = [[], [b"one"], words, chain, sorted(
        bytes(rng.integers(97, 100, int(rng.integers(0, 9))).astype(
            np.uint8)) for _ in range(2000))]
    chunk, plen, slen, pl, base, end = dba_pages(pages, dev)
    got = compare_k26(chunk, plen, slen, pl, base, end, "K26 pages", errs)
    flat = b"".join(b"".join(p) for p in pages)
    check(bytes(got[0].cpu().numpy()) == flat, "K26: bytes differ from the "
          "encoded strings")
    for page in pages:
        compare_k26(*dba_pages([page], dev), f"K26 {len(page)} strings",
                    errs)
        n_cases += 1
    # whole v2 chunks: the card's decode against the CPU's
    n = 20000
    valid = rng.random(n) > 0.15
    keys = rng.integers(0, 4000, n).astype(np.int64)
    codes = rng.integers(0, len(words), n)
    lens = np.asarray([len(words[c]) for c in codes], np.int64)
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    text = np.frombuffer(b"".join(words[c] for c in codes), np.uint8)
    sorted_text = string_rows(offs, text, np.argsort(codes, kind="stable"))
    cols = {
        "k": v2_spec("dict_fallback", keys, PHYS_INT64, valid=valid),
        "kp": v2_spec("dict_fallback", keys.astype(np.int32), PHYS_INT32,
                      fallback="plain"),
        "ts": v2_spec("delta", rng.integers(0, 2**50, n), PHYS_INT64,
                      CONV_TIMESTAMP_MICROS, valid=valid),
        "dt": v2_spec("delta", rng.integers(8000, 11000, n).astype(
            np.int32), PHYS_INT32, CONV_DATE),
        "f": v2_spec("bss", rng.standard_normal(n), PHYS_DOUBLE,
                     valid=valid),
        "p": v2_spec("flba", rng.integers(-10**8, 10**8, n), PHYS_FLBA,
                     type_length=4, decimal=(9, 2), valid=valid),
        "s": v2_spec("dlba", (offs, text), PHYS_BYTE_ARRAY, CONV_UTF8,
                     valid=valid),
        "c": v2_spec("dba", sorted_text, PHYS_BYTE_ARRAY, CONV_UTF8),
    }
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "v2.parquet")
        write_parquet_fixture(path, cols, 8192, 1024, v2=True,
                              dict_limit=8 * 1024)
        md = read_footer(path)
        mixed = 0
        for g in md.row_groups:
            for c in md.columns:
                ch = g.columns[c.name]
                raw = read_chunk(path, ch)
                args = (raw, c.dtype, g.num_rows, c.max_def)
                kw = dict(codec=ch.codec, physical=c.physical, name=c.name,
                          type_length=c.type_length)
                got = PD.decode_chunk_device(*args, device=dev, **kw)
                want = PD.decode_chunk_device(*args, **kw)
                label = f"v2 chunk {c.name} ({', '.join(ch.encodings)})"
                check(torch.equal(got.validity.cpu(), want.validity),
                      f"{label}: validity differs")
                if c.dtype.is_string:
                    check(torch.equal(got.offsets.cpu(), want.offsets),
                          f"{label}: offsets differ")
                    nb = int(want.offsets[-1])
                    check(torch.equal(got.data[:nb].cpu(), want.data[:nb]),
                          f"{label}: bytes differ")
                else:
                    check(bits_equal(got.data.cpu(), want.data),
                          f"{label}: values differ")
                mixed += "RLE_DICTIONARY" in ch.encodings and (
                    "DELTA_BINARY_PACKED" in ch.encodings)
                n_cases += 1
        check(mixed > 0, "no mixed dictionary -> DELTA chunk was written")
    return n_cases


def v2_chunk(cols: dict, dev, name: str):
    """(HostChunk of column `name` of a one-row-group v2 file of cols,
    its chunk on dev, its definition levels on dev) for timing."""
    import tempfile

    from spark_rapids_tpu_torch.io import parquet_device as PD
    from spark_rapids_tpu_torch.io.parquet_meta import read_chunk, \
        read_footer

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "t.parquet")
        write_parquet_fixture(path, cols, V2_ROW_GROUP, V2_PAGE_ROWS,
                              v2=True)
        md = read_footer(path)
        c = md.column(name)
        g = md.row_groups[0]
        ch = g.columns[name]
        hc = PD.prepare_chunk(read_chunk(path, ch), c.dtype, g.num_rows,
                              c.max_def, ch.codec, c.physical, name, True,
                              c.type_length)
    chunk = hc.buf_t.to(dev)
    cap = 1 << max(hc.num_rows - 1, 1).bit_length()
    levels = PD.hybrid_expand(chunk, PD.device_runs(hc.def_tabs, dev,
                                                    hc.rows), cap)
    return hc, chunk, levels, cap


# TPCx-BB's tables in the v2 layouts real files have: keys that overflow
# a 1 MiB dictionary fall back to DELTA pages; small-domain keys stay
# dictionaries; timestamps, INT32 counts and the dense review / item ids
# are DELTA; decimals are FLBA of the fewest bytes; i_category is
# DELTA_BYTE_ARRAY, pr_content DELTA_LENGTH_BYTE_ARRAY.
XBB_V2_DICT = ("ss_store_sk", "inv_warehouse_sk")
XBB_V2_FALLBACK = ("_item_sk", "_customer_sk", "_user_sk")
XBB_V2_DBA = ("i_category",)


def partition_columns(df):
    """Per partition of a generated table: {name: (values, validity)};
    STRING values as (offsets int64 [n + 1], UTF-8 bytes)."""
    import numpy as np

    out = []
    for part in df._plan.partitions:
        cols = {}
        for i, a in enumerate(df.schema):
            hosts = [b.columns[i] for b in part]
            valid = np.concatenate([h.validity for h in hosts])
            if a.data_type.is_string:
                offs, raws, base = [np.zeros(1, np.int64)], [], 0
                for h in hosts:
                    o, r = h.utf8()
                    o = o.astype(np.int64)
                    offs.append(o[1:] + base)
                    raws.append(r[:int(o[-1])])
                    base += int(o[-1])
                cols[a.name] = ((np.concatenate(offs),
                                 np.concatenate(raws)), valid)
            else:
                cols[a.name] = (np.concatenate([h.data for h in hosts]),
                                valid)
        out.append(cols)
    return out


def xbb_v2_spec(name: str, dtype, values, valid):
    import numpy as np

    from spark_rapids_tpu_torch.columnar.dtypes import DataType

    opts = {} if valid.all() else {"valid": valid}
    if dtype.is_string:
        return v2_spec("dba" if name in XBB_V2_DBA else "dlba", values,
                       PHYS_BYTE_ARRAY, CONV_UTF8, **opts)
    if getattr(dtype, "is_decimal", False):
        return v2_spec("flba", values.astype(np.int64), PHYS_FLBA,
                       type_length=min_flba_bytes(dtype.precision),
                       decimal=(dtype.precision, dtype.scale), **opts)
    if dtype is DataType.TIMESTAMP:
        return v2_spec("delta", values, PHYS_INT64, CONV_TIMESTAMP_MICROS,
                       **opts)
    if dtype is DataType.INT32:
        return v2_spec("delta", values, PHYS_INT32, **opts)
    if name in XBB_V2_DICT:
        pool, codes = np.unique(values, return_inverse=True)
        return ("dict", PHYS_INT64, None, (codes.ravel(), pool), opts)
    if name.endswith(XBB_V2_FALLBACK) and name != "i_item_sk":
        return v2_spec("dict_fallback", values.astype(np.int64),
                       PHYS_INT64, fallback="delta", **opts)
    return v2_spec("delta", values.astype(np.int64), PHYS_INT64, **opts)


def write_xbb_v2(raw: dict, root: str, names=None, row_group: int = None,
                 page_rows: int = None, dict_limit: int = None) -> dict:
    """The TPCx-BB tables `names` (default all) of `raw` written in the v2
    layout, one file a partition under root/<table>/, in row groups of
    V2_ROW_GROUP and pages of V2_PAGE_ROWS rows with DICT_LIMIT (unless
    given): {table: (directory, seconds, bytes)}. A table's partitions
    write on threads."""
    import glob
    from concurrent.futures import ThreadPoolExecutor

    row_group = row_group or V2_ROW_GROUP
    page_rows = page_rows or V2_PAGE_ROWS
    dict_limit = dict_limit or DICT_LIMIT

    out = {}
    for name in sorted(names or raw):
        df = raw[name]
        d = os.path.join(root, name)
        os.makedirs(d, exist_ok=True)
        t = time.perf_counter()

        def part(kc):
            k, cols = kc
            specs = {a.name: xbb_v2_spec(a.name, a.data_type,
                                         *cols[a.name]) for a in df.schema}
            write_parquet_fixture(os.path.join(d, f"part-{k:05d}.parquet"),
                                  specs, row_group, page_rows, v2=True,
                                  dict_limit=dict_limit)

        with ThreadPoolExecutor(max_workers=4) as ex:
            list(ex.map(part, enumerate(partition_columns(df))))
        out[name] = (d, time.perf_counter() - t, sum(
            os.path.getsize(f) for f in glob.glob(os.path.join(d, "*"))))
    return out


TPCH_V2_COLUMNS = ("l_returnflag", "l_linestatus", "l_quantity",
                   "l_extendedprice", "l_discount", "l_tax", "l_shipdate")


def run_parquet_v2_tpch(sess, raw, wants: dict, input_rows: dict,
                        launches: dict, root: str) -> dict:
    """Phase 4's SF 10 lineitem, the seven columns q1 and q6 read, written
    one file a partition in the v2 layout Arrow writers use for floats
    (the four DOUBLEs BYTE_STREAM_SPLIT, l_shipdate DELTA_BINARY_PACKED,
    the two flags dictionaries), then q1 and q6 over it (one cold and
    V2_WARM_REPS warm runs, paths parquet_v2_tpch_q1 / _q6) against phase
    4's numpy rows. Also returns V2_ROW_GROUP values of l_extendedprice
    for the kernel timings."""
    import numpy as np

    from spark_rapids_tpu_torch.benchmarks import tpch

    df = raw["lineitem"]
    sizes = [sum(b.num_rows for b in part) for part in df._plan.partitions]
    cuts = np.cumsum([0] + sizes)
    pools = {"l_returnflag": tpch._FLAGS, "l_linestatus": tpch._STATUS}
    cols = table_columns(df, TPCH_V2_COLUMNS)
    for name, pool in pools.items():
        cols[name] = pool_index(df, name, pool).astype(np.int32)
    d = os.path.join(root, "lineitem_v2")
    os.makedirs(d, exist_ok=True)
    t = time.perf_counter()
    for k in range(len(sizes)):
        a, b = int(cuts[k]), int(cuts[k + 1])
        specs = {}
        for name in TPCH_V2_COLUMNS:
            v = cols[name][a:b]
            if name in pools:
                specs[name] = dict_spec(v, pool_bytes(pools[name]),
                                        PHYS_BYTE_ARRAY, CONV_UTF8)
            elif name == "l_shipdate":
                specs[name] = v2_spec("delta", v, PHYS_INT32, CONV_DATE)
            else:
                specs[name] = v2_spec("bss", v, PHYS_DOUBLE)
        write_parquet_fixture(os.path.join(d, f"part-{k:05d}.parquet"),
                              specs, V2_ROW_GROUP, V2_PAGE_ROWS, v2=True)
    out = {"lineitem_v2_write": {
        "s": time.perf_counter() - t, "rows": int(cuts[-1]),
        "bytes": sum(os.path.getsize(os.path.join(d, f))
                     for f in os.listdir(d))}}
    log(f"parquet v2: lineitem ({int(cuts[-1])} rows, 7 columns) written in "
        f"{out['lineitem_v2_write']['s']:.3f} s, "
        f"{out['lineitem_v2_write']['bytes']} bytes")
    sample = cols["l_extendedprice"][:V2_ROW_GROUP].copy()
    del cols
    ptables = {"lineitem": sess.read.parquet(d)}
    from spark_rapids_tpu_torch import cuda_build as CB

    for q in ("q1", "q6"):
        name = f"parquet_v2_tpch_{q}"
        CB.reset_launch_counts()
        r = run_query(sess, tpch.QUERIES[q](ptables), wants[f"tpch_{q}"],
                      name, V2_WARM_REPS)
        launches[name] = CB.launch_counts()
        assert_file_leaves(sess)
        host = scan_host_s(sess)
        r.update(input_rows=input_rows[q],
                 rows_per_s=input_rows[q] / best_s(r),
                 last_run_scan_host_s=host,
                 checked_against="numpy (phase 4)")
        log(f"{name}: scan host {host:.3f} s of the last run "
            f"({last_s(r):.3f} s)")
        out[name] = r
    return out, sample


def run_parquet_v2_xbb(sess, raw: dict, cached: dict, table_rows: dict,
                       launches: dict, names, warm_reps: int = 3,
                       max_write_s: float = None, profile_dir=None) -> dict:
    """The v2 phase over TPCx-BB tables: write the tables `names` read in
    the v2 layout, then each query over read.parquet of those files, one
    cold and warm_reps warm runs, every leaf a TpuFileScanExec, its rows
    equal to the same query's over the cached tables (`cached`: path ->
    rows; integers, decimals and strings exactly, DOUBLE within a relative
    TPCH_REL); path parquet_v2_xbb_<q>. When writing the files took more
    than max_write_s, the queries are left out and the result says so.
    The files are removed at the end."""
    import shutil
    import tempfile

    from spark_rapids_tpu_torch.benchmarks import tpcxbb

    root = tempfile.mkdtemp(prefix="chip_smoke_v2_")
    out = {}
    try:
        need = set()
        for q in names:
            rec = TableRecorder(raw)
            tpcxbb.QUERIES[q](rec)
            need |= rec.seen
        written = write_xbb_v2(raw, root, sorted(need))
        for t, (_d, secs, nbytes) in written.items():
            out[f"write_{t}"] = {"s": secs, "bytes": nbytes,
                                 "rows": table_rows[t]}
            log(f"parquet v2: wrote {t} ({table_rows[t]} rows) in "
                f"{secs:.3f} s, {nbytes} bytes")
        out["write_s"] = sum(v[1] for v in written.values())
        if max_write_s is not None and out["write_s"] > max_write_s:
            out["left_out"] = (f"{names}: writing their tables took "
                               f"{out['write_s']:.1f} s, past "
                               f"{max_write_s} s")
            log(f"parquet v2: {out['left_out']}")
            return out
        ptables = {t: sess.read.parquet(d) for t, (d, _s, _b) in
                   written.items()}
        for q in names:
            name = f"parquet_v2_xbb_{q.split('_')[0]}"
            r = run_xbb_query(sess, name, tpcxbb.QUERIES[q], ptables,
                              table_rows, cached[f"tpcxbb_{q}"], launches,
                              warm_reps)
            assert_file_leaves(sess)
            r["last_run_scan_host_s"] = scan_host_s(sess)
            r["checked_against"] = "the cached tables' rows"
            log(f"{name}: scan host {r['last_run_scan_host_s']:.3f} s of "
                f"the last run ({last_s(r):.3f} s)")
            out[name] = r
        for q in ("q05_like", "q02_like"):  # device kernels and cProfile
            if profile_dir and q in names:
                name = f"parquet_v2_xbb_{q.split('_')[0]}"
                out[name]["profile"] = profile_query(
                    tpcxbb.QUERIES[q](ptables), profile_dir, name)
        out.update(no_fallback_check(sess, ptables))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def no_fallback_check(sess, ptables: dict, label: str = "parquet v2"
                      ) -> dict:
    """A device session whose kernel library fails to load: a read of the
    files raises (nothing decodes elsewhere instead)."""
    from spark_rapids_tpu_torch import cuda_build as CB
    from spark_rapids_tpu_torch.plan import functions as F

    real = CB.library

    def fail(name):
        raise RuntimeError(f"kernel library {name} failed to load")

    if sess.device.type != "cuda":  # CPU tensors take the plain versions
        return {}
    t = sorted(ptables)[0]
    CB.library = fail
    try:
        try:
            ptables[t].agg(F.count(ptables[t].schema[0].name)).collect()
            raised = ""
        except RuntimeError as e:
            raised = str(e)
    finally:
        CB.library = real
    check("failed to load" in raised, f"{label}: a read with the kernel "
          "library failing to load did not raise")
    log(f"{label}: with the kernel library failing to load, a read of "
        f"{t} raises ({raised})")
    return {"no_fallback": raised}


def geomean(xs) -> float:
    import numpy as np

    return float(np.exp(np.mean(np.log(xs))))


def time_parquet_v2_kernels(dev, errs: dict, samples: dict) -> dict:
    """K25, K26 and K21's BSS and FLBA modes at one 2^20-row row group of
    v2 pages (2^17 rows each), each checked against its plain version
    there: K25 over wcs_click_ts (DELTA), K21 FLBA over ss_net_paid (4-byte
    FLBA), K21 BSS over l_extendedprice, K26 over an l_comment-like column
    written as DELTA_BYTE_ARRAY (its two length streams through K25 first).
    samples: 2^20 host values of each column from the phases' tables. A
    bound counts each input read once (the chunk bytes the kernel reads,
    its tables, the levels) and each output written once."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.io import parquet_device as PD

    n = V2_ROW_GROUP
    iters, plain_iters = KERNEL_ITERS, PLAIN_ITERS
    rows = {}
    # K25 on wcs_click_ts
    hc, chunk, levels, cap = v2_chunk({"wcs_click_ts": v2_spec(
        "delta", samples["wcs_click_ts"][:n], PHYS_INT64,
        CONV_TIMESTAMP_MICROS)}, dev, "wcs_click_ts")
    st = PD.delta_streams(hc.deltas, dev)
    got = compare_k25(chunk, st, hc.present, "K25 wcs_click_ts", errs,
                      samples["wcs_click_ts"][:n].astype(np.int64))
    deltas = torch.diff(got, prepend=got[:1] * 0)
    n_mbs = int(st.mb_width.shape[0])
    stream_bytes = int(hc.buf.size) - (hc.byte_pos[0] if hc.byte_pos else 0)
    rows["delta_expand"] = dict(
        ms=cuda_ms(lambda: PD.delta_expand(chunk, st, hc.present), iters),
        plain_ms=cuda_ms(lambda: PD.delta_expand_plain(chunk, st,
                                                       hc.present),
                         plain_iters),
        library_ms=cuda_ms(lambda: torch.cumsum(deltas, 0), plain_iters),
        bound_ms=bound_ms(stream_bytes + 20 * n_mbs + 8 * hc.present),
        shape=f"{hc.present} TIMESTAMP values like wcs_click_ts in "
              f"{len(hc.kinds)} DELTA pages, {n_mbs} miniblocks, "
              f"widths {int(st.mb_width.min())}-{int(st.mb_width.max())}")
    # K21 FLBA on ss_net_paid
    hc, chunk, levels, cap = v2_chunk({"ss_net_paid": v2_spec(
        "flba", samples["ss_net_paid"][:n], PHYS_FLBA, type_length=4,
        decimal=(9, 2))}, dev, "ss_net_paid")
    src = PD.page_source(chunk, hc.kinds, hc.dense_end, hc.byte_pos)
    compare_k21_pages(levels, n, cap, src, 4, torch.int64, True,
                      "K21 FLBA ss_net_paid", errs)
    rows["k21_flba"] = dict(
        ms=cuda_ms(lambda: PD.page_decode_pages(levels, n, cap, src, 4,
                                                torch.int64, True), iters),
        plain_ms=cuda_ms(lambda: PD.page_decode_pages_plain(
            levels, n, cap, src, 4, torch.int64, True), plain_iters),
        library_ms=None,
        bound_ms=bound_ms(4 * n + 4 * hc.present + 9 * cap),
        shape=f"{n} rows like ss_net_paid, DECIMAL(9,2) in 4-byte "
              f"FIXED_LEN_BYTE_ARRAY, {len(hc.kinds)} pages")
    # K21 BSS on l_extendedprice
    hc, chunk, levels, cap = v2_chunk({"l_extendedprice": v2_spec(
        "bss", samples["l_extendedprice"][:n], PHYS_DOUBLE)}, dev,
        "l_extendedprice")
    src = PD.page_source(chunk, hc.kinds, hc.dense_end, hc.byte_pos)
    compare_k21_pages(levels, n, cap, src, 8, torch.float64, False,
                      "K21 BSS l_extendedprice", errs)
    planes = chunk[hc.byte_pos[0]:hc.byte_pos[0] + 8 * n]
    rows["k21_bss"] = dict(
        ms=cuda_ms(lambda: PD.page_decode_pages(levels, n, cap, src, 8,
                                                torch.float64), iters),
        plain_ms=cuda_ms(lambda: PD.page_decode_pages_plain(
            levels, n, cap, src, 8, torch.float64, False), plain_iters),
        # one call regroups the byte planes (as if one page)
        library_ms=cuda_ms(lambda: planes.view(8, n).t().contiguous(),
                           plain_iters),
        bound_ms=bound_ms(4 * n + 8 * hc.present + 9 * cap),
        shape=f"{n} DOUBLE rows like l_extendedprice in {len(hc.kinds)} "
              "BYTE_STREAM_SPLIT pages")
    # K26 on an l_comment-like column
    pool = comment_pool(37)
    codes = np.random.default_rng(37).integers(0, COMMENT_POOL, n)
    lens = np.asarray([len(x) for x in pool], np.int64)[codes]
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    pool_b = [x.encode() for x in pool]
    text = np.frombuffer(b"".join(pool_b[c] for c in codes), np.uint8)
    hc, chunk, levels, cap = v2_chunk({"l_comment": v2_spec(
        "dba", (offs, text), PHYS_BYTE_ARRAY, CONV_UTF8)}, dev, "l_comment")
    dense = PD.delta_expand(chunk, PD.delta_streams(hc.deltas, dev),
                            2 * hc.present)
    lo_hi = [(lo, lo + m) for lo, m, _b, _e in hc.dba]
    plen = torch.cat([dense[a:b] for a, b in lo_hi])
    slen = torch.cat([dense[hc.present + a:hc.present + b]
                      for a, b in lo_hi])
    pl = np.zeros(len(hc.dba) + 1, np.int64)
    np.cumsum([m for _lo, m, _b, _e in hc.dba], out=pl[1:])
    base = np.asarray([b for _lo, _m, b, _e in hc.dba])
    end = np.asarray([e for _lo, _m, _b, e in hc.dba])
    got = compare_k26(chunk, plen, slen, pl, base, end, "K26 l_comment",
                      errs)
    check(bytes(got[0].cpu().numpy()) == text.tobytes(),
          "K26 l_comment: bytes differ from the text")
    total = int(offs[-1])
    suffix = int(slen.sum())
    rows["delta_byte_array"] = dict(
        ms=cuda_ms(lambda: PD.delta_byte_array(chunk, plen, slen, pl, base,
                                               end), iters),
        plain_ms=cuda_ms(lambda: PD.delta_byte_array_plain(
            chunk, plen, slen, pl, base, end), plain_iters),
        library_ms=None,
        bound_ms=bound_ms(16 * n + suffix + 8 * n + 8 * (n + 1) + total),
        shape=f"{n} l_comment-like strings ({total} bytes, {suffix} of "
              f"suffixes) in {len(hc.dba)} DELTA_BYTE_ARRAY pages")
    return rows


# ------------------------------------------------- ORC phase (slice 10)
ORC_WARM_REPS = 0  # see V2_WARM_REPS
ORC_ROUND_TRIP_ROWS = 1 << 22    # the host table written and read back
ORC_HIVE_STRIPE_ROWS = 1 << 21   # ~64 MiB of the seven columns a stripe
ORC_HIVE_BLOCK = 256 << 10       # ZLIB blocks (orc.compress.size)
ORC_HIVE_ZLIB_LEVEL = 1
ORC_DATE_WINDOW = 128            # l_shipdate's literal runs
ORC_SHAPE_ROWS = PARQUET_SHAPE_ROWS  # one port-written lineitem stripe
ORC_WIDTHS = tuple(range(1, 25)) + (26, 28, 30, 32, 40, 48, 56, 64)
ORC_KINDS = ("SHORT_REPEAT", "DIRECT", "DELTA", "PATCHED_BASE")


def orc_fixed_bits(x):
    """ORC's closest fixed width of at least max(x, 1), per value."""
    import numpy as np

    t = np.asarray(ORC_WIDTHS)
    return t[np.searchsorted(t, np.maximum(np.asarray(x), 1))]


def orc_width_code(w):
    import numpy as np

    return np.searchsorted(np.asarray(ORC_WIDTHS), w)


def small_bit_length(u):
    """Bits of each value below 2^53 (0 for 0)."""
    import numpy as np

    u = np.asarray(u, np.int64)
    return np.where(u > 0, np.frexp(u.astype(np.float64))[1], 0).astype(
        np.int64)


def pack_fields(nbytes: int, bitpos, width, value):
    """Big-endian bit fields (widths 1-32, not overlapping) written at
    absolute bit positions of an nbytes buffer, vectorised."""
    import numpy as np

    bitpos = np.asarray(bitpos, np.int64)
    width = np.asarray(width, np.int64)
    check(bool((width <= 32).all()), "pack_fields takes widths to 32")
    out = np.zeros(nbytes + 8, np.float64)
    if len(bitpos) == 0:
        return np.zeros(nbytes, np.uint8)
    s = bitpos & 7
    mask = (np.ones_like(width) << width) - 1
    x = (np.asarray(value, np.int64) & mask) << (40 - s - width)
    base = bitpos >> 3
    for k in range(int(((s + width + 7) // 8).max())):
        part = (x >> (32 - 8 * k)) & 0xFF
        nz = part != 0
        out += np.bincount(base[nz] + k, weights=part[nz],
                           minlength=nbytes + 8)
    return out[:nbytes].astype(np.uint8)


def rlev2_encode(values, signed: bool, window: int = 512,
                 patch_every: int = 0):
    """An RLEv2 stream of `values`, vectorised, laid out as ORC's writer
    chooses (RunLengthIntegerWriterV2): 3-10 equal values a SHORT_REPEAT
    run, more a fixed DELTA run (512 at most, near-equal pieces), the
    values between them DIRECT runs of at most `window`. With
    patch_every = k, every k-th such window is a PATCHED_BASE run instead
    when its base-reduced values fit one bit fewer than the largest but
    for 1-31 of them (ORC's writer patches such outliers). Returns (bytes,
    runs of each kind)."""
    import numpy as np

    v = np.asarray(values, np.int64)
    n = len(v)
    counts = dict.fromkeys(ORC_KINDS, 0)
    if n == 0:
        return b"", counts
    starts = np.flatnonzero(np.r_[True, v[1:] != v[:-1]])
    lens = np.diff(np.r_[starts, n])
    rep = lens >= 3
    new = rep | np.r_[True, rep[:-1]]
    seg = np.cumsum(new) - 1
    seg_start = starts[new]
    seg_len = np.bincount(seg, weights=lens).astype(np.int64)
    seg_rep = rep[new]
    npieces = -(-seg_len // np.where(seg_rep, 512, window))
    pid = np.repeat(np.arange(len(seg_len)), npieces)
    k = np.arange(len(pid)) - np.repeat(np.cumsum(npieces) - npieces,
                                        npieces)
    L, P, rp = seg_len[pid], npieces[pid], seg_rep[pid]
    plen = np.where(rp, L // P + (k < L % P), np.minimum(window,
                                                         L - k * window))
    pstart = seg_start[pid] + np.where(rp, k * (L // P) + np.minimum(
        k, L % P), k * window)
    first = v[pstart]
    u_first = (first << 1) ^ (first >> 63) if signed else first
    kind = np.where(rp & (plen <= 10), 0, np.where(rp, 2, 1))
    # literal pieces: their values' zigzag (DIRECT) or base-reduced (PB)
    elem_piece = np.repeat(np.arange(len(plen)), plen)
    zz = (v << 1) ^ (v >> 63) if signed else v
    maxu = np.maximum.reduceat(zz, pstart)
    w_direct = orc_fixed_bits(small_bit_length(maxu))
    lo = np.minimum.reduceat(v, pstart)
    red = v - lo[elem_piece]
    full = small_bit_length(np.maximum.reduceat(red, pstart))
    wl = orc_fixed_bits(np.maximum(full - 1, 1))
    over = (red >> wl[elem_piece]) > 0
    n_over = np.bincount(elem_piece, weights=over,
                         minlength=len(plen)).astype(np.int64)
    lit_idx = np.cumsum(kind == 1) - 1
    if patch_every:
        pb = (kind == 1) & (lit_idx % patch_every == 0) & (full >= 2) & \
            (n_over >= 1) & (n_over <= 31) & (plen <= 256)
        kind = np.where(pb, 3, kind)
    is_pb = kind == 3
    # PATCHED_BASE geometry
    oe = over & is_pb[elem_piece]
    o_idx = np.flatnonzero(oe)
    o_piece = elem_piece[o_idx]
    o_pos = o_idx - pstart[o_piece]
    prev = np.r_[-1, o_piece[:-1]]
    gap = np.where(prev == o_piece, o_pos - np.r_[0, o_pos[:-1]], o_pos)
    pval = red[o_idx] >> wl[o_piece]
    pw = np.zeros(len(plen), np.int64)
    pgw = np.zeros(len(plen), np.int64)
    np.maximum.at(pw, o_piece, small_bit_length(pval))
    np.maximum.at(pgw, o_piece, small_bit_length(gap))
    pw = orc_fixed_bits(pw)
    pgw = np.maximum(pgw, 1)
    plw = orc_fixed_bits(pgw + pw)
    mag = np.abs(lo)
    bw = np.maximum((small_bit_length(mag) + 1 + 7) // 8, 1)
    # DELTA's base varint; SHORT_REPEAT's value bytes
    vmat, vlen = uvarint_matrix(u_first.view(np.uint64))
    sr_w = np.maximum((small_bit_length(u_first) + 7) // 8, 1)
    size = np.select(
        [kind == 0, kind == 2, kind == 1],
        [1 + sr_w, 2 + vlen + 1, 2 + (plen * w_direct + 7) // 8],
        4 + bw + (plen * wl + 7) // 8 + (n_over * plw + 7) // 8)
    off = np.cumsum(size) - size
    total = int(size.sum())
    # bit fields: DIRECT values, PB low bits and patch entries
    ep = elem_piece
    lit_e = (kind[ep] == 1) | (kind[ep] == 3)
    e_idx = np.flatnonzero(lit_e)
    pe = ep[e_idx]
    within = e_idx - pstart[pe]
    d = kind[pe] == 1
    fw = np.where(d, w_direct[pe], wl[pe])
    fstart = np.where(d, off[pe] + 2, off[pe] + 4 + bw[pe]) * 8
    fval = np.where(d, zz[e_idx], red[e_idx])
    list_start = (off[o_piece] + 4 + bw[o_piece] +
                  (plen[o_piece] * wl[o_piece] + 7) // 8) * 8
    entry_k = np.arange(len(o_idx)) - np.searchsorted(o_piece, o_piece)
    out = pack_fields(
        total, np.r_[fstart + within * fw, list_start + entry_k *
                     plw[o_piece]],
        np.r_[fw, plw[o_piece]],
        np.r_[fval, (gap << pw[o_piece]) | pval])
    # headers
    i0 = np.flatnonzero(kind == 0)
    out[off[i0]] = ((sr_w[i0] - 1) << 3) | (plen[i0] - 3)
    for j in range(8):
        sel = i0[sr_w[i0] > j]
        out[off[sel] + 1 + j] = (u_first[sel] >> (8 * (sr_w[sel] - 1 - j))) \
            & 0xFF
    for kd, code, wid in ((1, 1, w_direct), (2, 3, None), (3, 2, wl)):
        ii = np.flatnonzero(kind == kd)
        c = orc_width_code(wid[ii]) if wid is not None else 0
        out[off[ii]] = (code << 6) | (c << 1) | ((plen[ii] - 1) >> 8)
        out[off[ii] + 1] = (plen[ii] - 1) & 0xFF
    i2 = np.flatnonzero(kind == 2)
    for j in range(10):
        sel = i2[vlen[i2] > j]
        out[off[sel] + 2 + j] = vmat[sel, j]
    out[off[i2] + 2 + vlen[i2]] = 0  # delta 0
    i3 = np.flatnonzero(kind == 3)
    out[off[i3] + 2] = ((bw[i3] - 1) << 5) | orc_width_code(pw[i3])
    out[off[i3] + 3] = ((pgw[i3] - 1) << 5) | n_over[i3]
    bval = mag[i3] | np.where(lo[i3] < 0, 1 << (8 * bw[i3] - 1), 0)
    for j in range(8):
        sel = bw[i3] > j
        out[off[i3][sel] + 4 + j] = (bval[sel] >> (
            8 * (bw[i3][sel] - 1 - j))) & 0xFF
    for kd, name in enumerate(ORC_KINDS):
        counts[name] = int((kind == kd).sum())
    return out.tobytes(), counts


def _orc_framed(payload: bytes, block: int, level: int) -> bytes:
    """ZLIB blocks of `block` bytes in ORC's framing."""
    import zlib

    out = []
    for i in range(0, len(payload), block):
        chunk = payload[i:i + block]
        c = zlib.compressobj(level, zlib.DEFLATED, -15)
        comp = c.compress(chunk) + c.flush()
        h, body = (len(comp) << 1, comp) if len(comp) < len(chunk) else \
            ((len(chunk) << 1) | 1, chunk)
        out.append(bytes((h & 0xFF, (h >> 8) & 0xFF, h >> 16)) + body)
    return b"".join(out)


def _pb_varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _pb_int(f: int, v: int) -> bytes:
    return _pb_varint(f << 3) + _pb_varint(v)


def _pb_bytes(f: int, b: bytes) -> bytes:
    return _pb_varint((f << 3) | 2) + _pb_varint(len(b)) + b


def orc_fixture_columns(rng, n: int) -> dict:
    """lineitem's q1 / q6 columns at n rows, shaped as the generator makes
    them, for write_orc_fixture: {name: (kind, values, pool)}."""
    import numpy as np

    return {
        "l_returnflag": ("dict", rng.integers(0, 3, n), ["A", "N", "R"]),
        "l_linestatus": ("dict", rng.integers(0, 2, n), ["F", "O"]),
        "l_quantity": ("double", rng.integers(1, 51, n).astype(np.float64),
                       None),
        "l_extendedprice": ("double", (rng.random(n) * 1e5).round(2), None),
        "l_discount": ("double", rng.integers(0, 11, n) / 100.0, None),
        "l_tax": ("double", rng.integers(0, 9, n) / 100.0, None),
        "l_shipdate": ("date", rng.integers(8035, 10561, n).astype(np.int32),
                       None)}


def write_orc_fixture(path: str, cols: dict, stripe_rows: int,
                      block: int = ORC_HIVE_BLOCK,
                      level: int = ORC_HIVE_ZLIB_LEVEL) -> dict:
    """An ORC file laid out as Hive's and Spark's writers (ORC's Java
    writer) lay it out, with numpy only: ZLIB in `block`-byte blocks,
    stripes of stripe_rows rows, DOUBLE columns raw, DATE columns RLEv2
    (every second literal run of ORC_DATE_WINDOW values a PATCHED_BASE
    run where its outliers allow), STRING columns DICTIONARY_V2 (a sorted
    dictionary a stripe; indices and lengths RLEv2). cols: {name: (kind,
    values, pool)} with kind "double", "date" or "dict" (values: indices
    into pool). Returns the runs of each RLEv2 kind and the stripe count;
    stripes encode and compress on 8 threads."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    names = list(cols)
    n = len(next(iter(cols.values()))[1])
    kinds = dict.fromkeys(ORC_KINDS, 0)
    sorted_pools = {}
    for name, (kind, _v, pool) in cols.items():
        if kind == "dict":
            order = sorted(range(len(pool)), key=lambda i: pool[i].encode())
            rank = np.empty(len(pool), np.int64)
            rank[order] = np.arange(len(pool))
            sorted_pools[name] = ([pool[i].encode() for i in order], rank)

    def stripe(a: int):
        """A stripe's compressed streams and footer, and its run counts
        (numpy and zlib release the GIL, so stripes encode on threads)."""
        b = min(n, a + stripe_rows)
        streams, encodings = [], [_pb_int(1, 0)]
        runs = dict.fromkeys(ORC_KINDS, 0)

        def add(c):
            for key in ORC_KINDS:
                runs[key] += c[key]

        for ci, name in enumerate(names):
            kind, values, _pool = cols[name]
            v = values[a:b]
            if kind == "double":
                streams.append((1, ci + 1, np.ascontiguousarray(
                    v, dtype="<f8").tobytes()))
                encodings.append(_pb_int(1, 0))
            elif kind == "date":
                data, c = rlev2_encode(v, True, ORC_DATE_WINDOW, 2)
                add(c)
                streams.append((1, ci + 1, data))
                encodings.append(_pb_int(1, 2))
            else:
                entries, rank = sorted_pools[name]
                data, c = rlev2_encode(rank[v], False)
                add(c)
                lens, c2 = rlev2_encode([len(e) for e in entries], False)
                add(c2)
                streams += [(1, ci + 1, data), (2, ci + 1, lens),
                            (3, ci + 1, b"".join(entries))]
                encodings.append(_pb_int(1, 3) + _pb_int(2, len(entries)))
        wires = [_orc_framed(p, block, level) for _k, _c, p in streams]
        footer = b"".join(_pb_bytes(1, _pb_int(1, k) + _pb_int(2, c) +
                                    _pb_int(3, len(w)))
                          for (k, c, _p), w in zip(streams, wires))
        footer += b"".join(_pb_bytes(2, e) for e in encodings)
        footer = _orc_framed(footer + _pb_bytes(3, b"UTC"), block, level)
        return wires, footer, b - a, runs

    stripes = []
    with open(path, "wb") as f, ThreadPoolExecutor(max_workers=8) as ex:
        f.write(b"ORC")
        offset = 3
        for wires, footer, rows, runs in ex.map(stripe, range(
                0, n, stripe_rows)):
            dlen = sum(len(w) for w in wires)
            for w in wires:
                f.write(w)
            f.write(footer)
            stripes.append((offset, dlen, len(footer), rows))
            offset += dlen + len(footer)
            for key in ORC_KINDS:
                kinds[key] += runs[key]
        type_id = {"double": 6, "date": 15, "dict": 7}
        root = _pb_int(1, 12) + b"".join(_pb_int(2, i + 1)
                                         for i in range(len(names)))
        root += b"".join(_pb_bytes(3, nm.encode()) for nm in names)
        footer = _pb_int(1, 3) + _pb_int(2, offset)
        footer += b"".join(_pb_bytes(3, _pb_int(1, o) + _pb_int(2, 0) +
                                     _pb_int(3, d) + _pb_int(4, fl) +
                                     _pb_int(5, r))
                           for o, d, fl, r in stripes)
        footer += _pb_bytes(4, root) + b"".join(
            _pb_bytes(4, _pb_int(1, type_id[cols[nm][0]])) for nm in names)
        footer += _pb_int(6, n) + _pb_int(8, 0)
        footer = _orc_framed(footer, block, level)
        ps = (_pb_int(1, len(footer)) + _pb_int(2, 1) + _pb_int(3, block) +
              _pb_int(4, 0) + _pb_int(4, 12) + _pb_int(5, 0) + _pb_int(6, 1)
              + _pb_bytes(8000, b"ORC"))
        f.write(footer + ps + bytes([len(ps)]))
    kinds["stripes"] = len(stripes)
    return kinds


def orc_round_trip(sess, root: str, launches: dict) -> dict:
    """A host table with NULLs in every column type the writer takes
    (BOOLEAN, SHORT, INT, LONG, DATE, FLOAT, DOUBLE, STRING;
    ORC_ROUND_TRIP_ROWS rows), written by df.write.orc (SNAPPY) from the
    host (the writer uploads it:
    K29 and K22's ORC mode must launch) and read back bit for bit on the
    card (K27, K28: PRESENT streams and BOOLEAN values); path
    orc_round_trip. The files are removed at the end."""
    import shutil

    import numpy as np

    from spark_rapids_tpu_torch import cuda_build as CB
    from spark_rapids_tpu_torch.columnar.batch import HostColumnVector
    from spark_rapids_tpu_torch.columnar.dtypes import DataType

    n = ORC_ROUND_TRIP_ROWS
    rng = np.random.default_rng(41)
    spec = [("b", DataType.BOOL, rng.random(n) < 0.5),
            ("s16", DataType.INT16, rng.integers(-2**15, 2**15, n).astype(
                np.int16)),
            ("i32", DataType.INT32, rng.integers(-2**31, 2**31, n).astype(
                np.int32)),
            ("i64", DataType.INT64, rng.integers(-2**62, 2**62, n)),
            ("d", DataType.DATE, rng.integers(-5000, 20000, n).astype(
                np.int32)),
            ("f32", DataType.FLOAT32, rng.standard_normal(n).astype(
                np.float32)),
            ("f64", DataType.FLOAT64, rng.standard_normal(n))]
    cols, schema = {}, []
    for i, (name, dt, data) in enumerate(spec):
        valid = rng.random(n) >= 0.01 * (i + 1)
        cols[name] = HostColumnVector(dt, np.where(valid, data, np.zeros(
            (), data.dtype)), valid)
        schema.append((name, dt))
    s = HostColumnVector.from_pool(comment_pool(43),
                                   rng.integers(0, COMMENT_POOL, n))
    s_valid = rng.random(n) >= 0.05
    offs, raw = s.utf8()
    lens = np.where(s_valid, np.diff(offs), 0)
    new_offs = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=new_offs[1:])
    src = np.repeat(offs[:-1].astype(np.int64) - new_offs[:-1], lens) + \
        np.arange(int(new_offs[-1]))
    cols["s"] = HostColumnVector(DataType.STRING, s.data, s_valid, (
        new_offs.astype(np.int32), raw[src]))
    schema.append(("s", DataType.STRING))
    df = sess.createDataFrame(cols, [(k, dt.value) for k, dt in schema])
    path = os.path.join(root, "round_trip")
    CB.reset_launch_counts()
    t = time.perf_counter()
    df.write.option("compression", "snappy").orc(path)
    write_s = time.perf_counter() - t
    assert_on_device(sess)
    got = CB.launch_counts()
    k29, k30 = got.get("orc_encode_direct", 0), got.get("orc_pack_present",
                                                         0)
    check(sess.device.type != "cuda" or (k29 > 0 and k29 * 4 == k30 * 5),
          "orc round trip: K29 / K22 "
          f"ORC-mode launches {got} (5 and 4 a stripe)")
    t = time.perf_counter()
    rows = check_round_trip(sess, df, path, "orc round trip", "orc")
    read_s = time.perf_counter() - t
    launches["orc_round_trip"] = CB.launch_counts()
    shutil.rmtree(path, ignore_errors=True)
    log(f"orc: a host table of {rows} rows with NULLs in 8 types written "
        f"(SNAPPY) in {write_s:.3f} s and read back bit for bit in "
        f"{read_s:.3f} s")
    return {"rows": rows, "write_s": write_s, "read_and_check_s": read_s}


def run_orc(sess, raw, tables, wants: dict, input_rows: dict,
            launches: dict, profile_dir=None) -> dict:
    """The ORC phase, over phase 4's cached SF 10 tables: write the six
    q1-q5 tables with df.write.orc (SNAPPY; orders also ZLIB), read the
    ZLIB orders back bit for bit, the host-table round trip, q1, q6, q3
    and q5 over the SNAPPY files (one cold and ORC_WARM_REPS warm runs,
    every leaf a TpuFileScanExec, rows against numpy), then the Hive-layout
    lineitem (run_orc_hive); the files are removed at the end."""
    import glob
    import shutil
    import tempfile

    import torch

    from spark_rapids_tpu_torch import cuda_build as CB
    from spark_rapids_tpu_torch.benchmarks import tpch

    root = tempfile.mkdtemp(prefix="chip_smoke_orc_")
    out = {"write": {}}
    try:
        CB.reset_launch_counts()
        for name, codec in [(t, "snappy") for t in PARQUET_TABLES] + [
                ("orders", "zlib")]:
            path = os.path.join(root, name if codec == "snappy" else
                                f"{name}_{codec}")
            torch.cuda.synchronize()
            t = time.perf_counter()
            tables[name].write.option("compression", codec).orc(path)
            secs = time.perf_counter() - t
            assert_on_device(sess)
            nbytes = sum(os.path.getsize(p) for p in glob.glob(
                os.path.join(path, "*.orc")))
            out["write"][f"{name}_{codec}"] = {"s": secs, "bytes": nbytes}
            log(f"orc: wrote {name} ({codec}) in {secs:.3f} s, {nbytes} "
                "bytes")
        launches["orc_write"] = CB.launch_counts()
        t = time.perf_counter()
        n = check_round_trip(sess, raw["orders"], os.path.join(
            root, "orders_zlib"), "orc orders round trip", "orc")
        out["orders_round_trip"] = {"rows": n, "s": time.perf_counter() - t}
        log(f"orc: orders ({n} rows, ZLIB) read back bit for bit")
        out["round_trip"] = orc_round_trip(sess, root, launches)
        otables = {k: sess.read.orc(os.path.join(root, k))
                   for k in PARQUET_TABLES}
        for q in ("q1", "q6", "q3", "q5"):
            name = f"orc_tpch_{q}"
            CB.reset_launch_counts()
            out[name] = run_query(sess, tpch.QUERIES[q](otables),
                                  wants[f"tpch_{q}"], name, ORC_WARM_REPS)
            launches[name] = CB.launch_counts()
            assert_file_leaves(sess)
            host = scan_host_s(sess)
            out[name].update(input_rows=input_rows[q],
                             rows_per_s=input_rows[q] / best_s(out[name]),
                             last_run_scan_host_s=host,
                             checked_against="numpy (phases 4-5)")
            log(f"{name}: scan host {host:.3f} s of the last run "
                f"({last_s(out[name]):.3f} s)")
        if profile_dir:
            out["orc_tpch_q1"]["profile"] = profile_query(
                tpch.q1(otables), profile_dir, "orc_tpch_q1")
        for k in PARQUET_TABLES:
            shutil.rmtree(os.path.join(root, k), ignore_errors=True)
        out.update(run_orc_hive(sess, raw, wants, input_rows, launches,
                                root))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def run_orc_hive(sess, raw, wants: dict, input_rows: dict, launches: dict,
                 root: str) -> dict:
    """Phase 4's SF 10 lineitem, the seven columns q1 and q6 read, written
    one file a partition by write_orc_fixture (Hive's layout: ZLIB blocks
    of 256 KiB, stripes of 2^21 rows, the flags DICTIONARY_V2, every RLEv2
    sub-encoding), then q1 and q6 over it (paths orc_hive_q1 / _q6, one
    cold and ORC_WARM_REPS warm runs) against phase 4's numpy rows, then a
    read with the kernel library failing to load must raise."""
    import numpy as np

    from spark_rapids_tpu_torch.benchmarks import tpch
    from spark_rapids_tpu_torch import cuda_build as CB

    df = raw["lineitem"]
    sizes = [sum(b.num_rows for b in part) for part in df._plan.partitions]
    cuts = np.cumsum([0] + sizes)
    pools = {"l_returnflag": tpch._FLAGS, "l_linestatus": tpch._STATUS}
    cols = table_columns(df, TPCH_V2_COLUMNS)
    for name, pool in pools.items():
        cols[name] = pool_index(df, name, pool)
    d = os.path.join(root, "lineitem_hive")
    os.makedirs(d, exist_ok=True)
    kinds = dict.fromkeys(ORC_KINDS + ("stripes",), 0)
    t = time.perf_counter()
    for k in range(len(sizes)):
        a, b = int(cuts[k]), int(cuts[k + 1])
        spec = {}
        for name in TPCH_V2_COLUMNS:
            v = cols[name][a:b]
            spec[name] = ("dict", v, pools[name]) if name in pools else \
                ("date", v, None) if name == "l_shipdate" else \
                ("double", v, None)
        got = write_orc_fixture(os.path.join(d, f"part-{k:05d}.orc"), spec,
                                ORC_HIVE_STRIPE_ROWS)
        for key in kinds:
            kinds[key] += got[key]
    out = {"lineitem_hive_write": {
        "s": time.perf_counter() - t, "rows": int(cuts[-1]),
        "bytes": sum(os.path.getsize(os.path.join(d, f))
                     for f in os.listdir(d)), "runs": kinds}}
    check(all(kinds[k] > 0 for k in ORC_KINDS),
          f"orc hive lineitem lacks an RLEv2 sub-encoding: {kinds}")
    log(f"orc hive: lineitem ({int(cuts[-1])} rows, 7 columns, "
        f"{kinds['stripes']} stripes) written in "
        f"{out['lineitem_hive_write']['s']:.3f} s, "
        f"{out['lineitem_hive_write']['bytes']} bytes; RLEv2 runs {kinds}")
    del cols
    htables = {"lineitem": sess.read.orc(d)}
    for q in ("q1", "q6"):
        name = f"orc_hive_{q}"
        CB.reset_launch_counts()
        r = run_query(sess, tpch.QUERIES[q](htables), wants[f"tpch_{q}"],
                      name, ORC_WARM_REPS)
        launches[name] = CB.launch_counts()
        assert_file_leaves(sess)
        host = scan_host_s(sess)
        r.update(input_rows=input_rows[q],
                 rows_per_s=input_rows[q] / best_s(r),
                 last_run_scan_host_s=host,
                 checked_against="numpy (phase 4)")
        log(f"{name}: scan host {host:.3f} s of the last run "
            f"({last_s(r):.3f} s)")
        out[name] = r
    out.update(no_fallback_check(sess, htables, "orc"))
    return out


# ---------------------------------------------- ORC kernel checks (phase 3)
def be_pack(values, w: int) -> bytes:
    """Python ints as one big-endian bit string of w bits each, padded to
    a byte."""
    acc = 0
    for v in values:
        acc = (acc << w) | (int(v) & ((1 << w) - 1))
    nbits = len(values) * w
    pad = (-nbits) % 8
    return (acc << pad).to_bytes((nbits + pad) // 8, "big") if nbits else b""


def rle_sr(value: int, count: int, signed: bool) -> bytes:
    u = ((value << 1) ^ (value >> 63)) & ((1 << 64) - 1) if signed else value
    vw = max(1, (u.bit_length() + 7) // 8)
    return bytes([((vw - 1) << 3) | (count - 3)]) + u.to_bytes(vw, "big")


def _hdr(enc: int, w: int, n: int) -> bytes:
    code = ORC_WIDTHS.index(w) if w else 0
    return bytes([(enc << 6) | (code << 1) | ((n - 1) >> 8), (n - 1) & 0xFF])


def rle_direct(values, w: int, signed: bool) -> bytes:
    """DIRECT runs of at most 512 values."""
    us = [((v << 1) ^ (v >> 63)) & ((1 << 64) - 1) if signed else v
          for v in values]
    return b"".join(_hdr(1, w, len(us[i:i + 512])) + be_pack(us[i:i + 512],
                                                              w)
                    for i in range(0, len(us), 512))


def _svarint(v: int) -> bytes:
    return _pb_varint(((v << 1) ^ (v >> 63)) & ((1 << 64) - 1))


def rle_delta(base: int, d0: int, deltas, w: int, n: int,
              signed: bool) -> bytes:
    """A DELTA run of n values: base, then + d0, then +/- the unsigned
    deltas (n - 2 of them, width w; w = 0: a fixed step d0)."""
    head = _hdr(3, w, n) + (_svarint(base) if signed else _pb_varint(base))
    return head + _svarint(d0) + (be_pack(deltas, w) if w else b"")


def rle_pb(base: int, lows, w: int, patches, pw: int, pgw: int) -> bytes:
    """A PATCHED_BASE run: base + low bits (width w), patch entries (gap,
    value) of pw value bits and pgw gap bits."""
    mag = abs(base)
    bw = max(1, (mag.bit_length() + 1 + 7) // 8)
    bval = mag | ((1 << (8 * bw - 1)) if base < 0 else 0)
    plw = next(x for x in ORC_WIDTHS if x >= pgw + pw)
    n = len(lows)
    return (_hdr(2, w, n) + bytes([((bw - 1) << 5) | ORC_WIDTHS.index(pw),
                                   ((pgw - 1) << 5) | len(patches)]) +
            bval.to_bytes(bw, "big") + be_pack(lows, w) +
            be_pack([(g << pw) | p for g, p in patches], plw))


def orc_nano_code(v: int) -> int:
    """Nanoseconds as ORC's writers store them: trailing zeros counted in
    the low 3 bits (TimestampTreeWriter.formatNanos)."""
    if v == 0 or v % 100:
        return v << 3
    v //= 100
    z = 1
    while v % 10 == 0 and z < 7:
        v //= 10
        z += 1
    return (v << 3) | z


def byte_rle(pieces) -> bytes:
    """('run', byte, count 3-130) / ('lit', bytes 1-128) pieces."""
    out = bytearray()
    for p in pieces:
        if p[0] == "run":
            out += bytes([p[2] - 3, p[1]])
        else:
            out.append(256 - len(p[1]))
            out += p[1]
    return bytes(out)


def compare_k27(buf: bytes, n: int, signed: bool, cap: int, label: str,
                errs: dict, dev) -> int:
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.io import orc_device as OD

    arr = np.frombuffer(buf, np.uint8) if buf else np.zeros(1, np.uint8)
    rt = OD.parse_rlev2(arr, 0, len(buf), n, signed)
    got = OD.rlev2_expand(torch.from_numpy(arr.copy()).to(dev),
                          OD.device_rlev2(rt, dev), cap)
    want = OD.rlev2_expand_plain(torch.from_numpy(arr.copy()),
                                 OD.device_rlev2(rt, "cpu"), cap)
    check(torch.equal(got.cpu(), want), f"{label}: K27 differs from its "
          "plain version")
    errs["rlev2_expand"] = max(errs.get("rlev2_expand", 0.0),
                               max_abs_err(got.cpu(), want))
    return rt.produced


def compare_k28(buf: bytes, cap: int, label: str, errs: dict, dev) -> None:
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.io import orc_device as OD

    arr = np.frombuffer(buf, np.uint8) if buf else np.zeros(1, np.uint8)
    bt = OD.parse_byte_rle(arr, 0, len(buf), cap)
    got = OD.present_expand(torch.from_numpy(arr.copy()).to(dev),
                            OD.device_byte_rle(bt, dev), cap)
    want = OD.present_expand_plain(torch.from_numpy(arr.copy()),
                                   OD.device_byte_rle(bt, "cpu"), cap)
    check(torch.equal(got.cpu(), want), f"{label}: K28 differs from its "
          "plain version")


def compare_k29(data, valid, n: int, signed: bool, label: str,
                errs: dict) -> None:
    import torch

    from spark_rapids_tpu_torch.io import orc_encode_device as OE

    got = OE.encode_direct(data, valid, n, signed)
    want = OE.encode_direct_plain(data.cpu(), None if valid is None else
                                  valid.cpu(), n, signed)
    counts = got[2].cpu()
    check(torch.equal(counts, want[2]), f"{label}: K29 counts "
          f"{counts.tolist()} vs {want[2].tolist()}")
    nb = int(counts[2])
    check(torch.equal(got[0][:nb].cpu(), want[0][:nb]),
          f"{label}: K29 stream differs")
    check(torch.equal(got[1].cpu(), want[1]), f"{label}: K29 PRESENT "
          "bits differ")


def compare_k30(col, n: int, label: str, errs: dict) -> None:
    import torch

    from spark_rapids_tpu_torch.io import parquet_encode_device as PE

    got = PE.encode_plain_page(col, n, orc=True)
    want = PE.encode_plain_page_plain(col, n, orc=True)
    counts = got[2].cpu()
    check(torch.equal(counts, want[2].cpu()), f"{label}: K22 ORC mode "
          f"counts {counts.tolist()} vs {want[2].tolist()}")
    nb = int(counts[1])
    check(torch.equal(got[0][:nb], want[0][:nb]) and
          torch.equal(got[1], want[1]), f"{label}: K22 ORC mode differs")


def orc_edge_cases(dev, errs: dict) -> int:
    """K27-K29 and K22's ORC mode against their plain versions, bit for
    bit: every RLEv2 sub-encoding, DIRECT and DELTA widths 1-64, runs of 1,
    3, 10 and 512, patches at a run's first and last value, signed and
    unsigned streams, an empty stream and slots past the runs; byte-RLE
    runs and literals across byte and run boundaries; encodes of every
    integer width with NULLs, no live row and every row live; whole stripe
    columns (BOOLEAN, SHORT, INT, FLOAT, STRING, a UTC TIMESTAMP, an
    all-NULL column) decoded on the card against the CPU."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.columnar.batch import ColumnVector
    from spark_rapids_tpu_torch.columnar.dtypes import DataType

    rng = np.random.default_rng(61)
    sets = 0
    # every DIRECT width, runs of 1, 3, 10 and 512, signed and unsigned
    for signed in (True, False):
        parts, n = [], 0
        for w in ORC_WIDTHS:
            for cnt in (1, 3, 10, 512):
                if signed:
                    lo, hi = -(1 << (w - 1)), (1 << (w - 1)) - 1
                else:
                    lo, hi = 0, (1 << min(w, 63)) - 1
                vals = [int(x) for x in rng.integers(lo, hi, cnt,
                                                     endpoint=True)]
                vals[-1] = hi
                parts.append(rle_direct(vals, w, signed))
                n += cnt
        compare_k27(b"".join(parts), n, signed, n + 100,
                    f"DIRECT widths 1-64 ({'signed' if signed else 'unsigned'})",
                    errs, dev)
        sets += 1
    # SHORT_REPEAT values of 1-8 bytes, 3-10 repeats
    parts, n = [], 0
    for vw in range(1, 9):
        for cnt in range(3, 11):
            v = int(rng.integers(-(1 << (8 * vw - 2)), 1 << (8 * vw - 2)))
            parts.append(rle_sr(v, cnt, True))
            n += cnt
    compare_k27(b"".join(parts), n, True, n, "SHORT_REPEAT", errs, dev)
    sets += 1
    # DELTA: varying widths to 64, both directions, fixed steps
    parts, n = [], 0
    for w in (2, 7, 13, 32, 48, 56, 64):  # DELTA has no width 1 (code 0)
        for cnt in (3, 10, 512):
            deltas = [int(x) for x in rng.integers(0, 1 << min(w, 62),
                                                   cnt - 2)]
            for d0 in (5, -5):
                parts.append(rle_delta(int(rng.integers(-1000, 1000)), d0,
                                       deltas, w, cnt, True))
                n += cnt
    for cnt in (1, 2, 3, 10, 511, 512):
        parts.append(rle_delta(7, -3, [], 0, cnt, True))
        n += cnt
    compare_k27(b"".join(parts), n, True, n + 8, "DELTA", errs, dev)
    compare_k27(rle_delta(1 << 40, 3, [1, 2, 3], 2, 5, False), 5, False, 8,
                "DELTA unsigned", errs, dev)
    sets += 2
    # PATCHED_BASE: patches on the first and last value, wide patches
    parts, n = [], 0
    for w, pw in ((1, 1), (3, 8), (11, 4), (20, 40), (32, 30), (56, 7)):
        for cnt in (1, 10, 512):
            lows = [int(x) for x in rng.integers(0, 1 << w, cnt)]
            patches, prev = [], 0
            for p in sorted({0, cnt // 2, cnt - 1}):
                g = p - prev
                while g > 255:  # a gap past 8 bits takes filler entries
                    patches.append((255, 0))
                    g -= 255
                patches.append((g, int(rng.integers(1, 1 << pw))))
                prev = p
            pgw = max(1, max(g for g, _ in patches).bit_length())
            parts.append(rle_pb(int(rng.integers(-10**6, 10**6)), lows, w,
                                patches, pw, pgw))
            n += cnt
    compare_k27(b"".join(parts), n, True, n, "PATCHED_BASE", errs, dev)
    sets += 1
    # a stream mixing every kind; an empty one; the fixture's encoder
    mixed = rle_sr(9, 4, True) + rle_direct([1, -2, 3], 4, True) + \
        rle_delta(100, -2, [1, 0, 3], 2, 5, True) + \
        rle_pb(-7, [1, 2, 3, 0], 2, [(3, 1)], 1, 2)
    compare_k27(mixed, 16, True, 40, "mixed", errs, dev)
    compare_k27(b"", 0, True, 8, "empty stream", errs, dev)
    flags = rng.integers(0, 3, 1 << 16)
    buf, _ = rlev2_encode(flags, False)
    check(compare_k27(buf, len(flags), False, len(flags), "fixture flags",
                      errs, dev) == len(flags), "fixture flags: short")
    dates = rng.integers(8035, 10561, 1 << 16)
    buf, c = rlev2_encode(dates, True, ORC_DATE_WINDOW, 2)
    check(c["PATCHED_BASE"] > 0, "fixture dates: no PATCHED_BASE run")
    compare_k27(buf, len(dates), True, len(dates), "fixture dates", errs,
                dev)
    sets += 4
    # byte-RLE: runs and literals across byte boundaries, a ragged end
    pieces = [("run", 0xFF, 3), ("lit", bytes([0x80, 0x01, 0x55])),
              ("run", 0x00, 130), ("lit", bytes(range(128))),
              ("run", 0xA5, 4), ("lit", bytes([0x7F]))]
    buf = byte_rle(pieces)
    total = 3 + 3 + 130 + 128 + 4 + 1
    for cap in (total * 8 - 5, total * 8, total * 8 + 64, 8):
        compare_k28(buf, cap, f"byte-RLE cap {cap}", errs, dev)
    compare_k28(b"", 16, "empty byte-RLE", errs, dev)
    sets += 5
    # K29: every integer width, NULLs, short, none and all live
    cap = 1040
    for dt, bits in ((torch.int16, 16), (torch.int32, 32),
                     (torch.int64, 64)):
        for w in (1, 2, 4, 8, 13, 16, 24, 31, 40, 48, 56, 64):
            if w > bits:
                continue
            hi = (1 << (w - 1)) - 1
            vals = rng.integers(-hi - 1, hi, cap, endpoint=True)
            data = torch.from_numpy(vals).to(dt).to(dev)
            for case, valid, n in (
                    ("nulls", rng.random(cap) < 0.7, cap - 5),
                    ("none", np.zeros(cap, bool), cap),
                    ("all", None, cap)):
                v = None if valid is None else torch.from_numpy(valid).to(
                    dev)
                compare_k29(data, v, n, True, f"K29 {dt} w{w} {case}", errs)
                sets += 1
    lens = torch.from_numpy(rng.integers(0, 300, cap).astype(
        np.int32)).to(dev)
    compare_k29(lens, None, cap - 3, False, "K29 lengths", errs)
    sets += 1
    # K22's ORC mode
    valid = torch.from_numpy(rng.random(64) < 0.6).to(dev)
    for dtype, data in ((DataType.FLOAT32, torch.randn(64)),
                        (DataType.FLOAT64, torch.randn(64, dtype=torch.float64)),
                        (DataType.BOOL, torch.rand(64) < 0.5)):
        col = ColumnVector(dtype, data.to(dev), valid)
        compare_k30(col, 61, f"K22 ORC mode {dtype.name}", errs)
        compare_k30(ColumnVector(dtype, data.to(dev), torch.zeros_like(
            valid)), 64, f"K22 ORC mode {dtype.name} all NULL", errs)
        sets += 2
    offs, raw, sv = pool_column(comment_pool(7), 64, 7, dev)
    compare_k30(ColumnVector(DataType.STRING, raw, sv & valid, offs, 64), 60,
                "K22 ORC mode STRING", errs)
    sets += 1
    sets += orc_stripe_edge_cases(dev, errs, rng)
    return sets


def orc_stripe_edge_cases(dev, errs: dict, rng) -> int:
    """Whole stripe columns built in memory (streams, encodings, a UTC
    time zone) decoded on the card and on the CPU, equal bit for bit:
    BOOLEAN with NULLs, SHORT, INT, FLOAT, DOUBLE, DIRECT_V2 and
    DICTIONARY_V2 STRING, TIMESTAMP (pre-1970 fractions too), an all-NULL
    INT column and a stripe of no rows."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.columnar.batch import bucket_capacity
    from spark_rapids_tpu_torch.columnar.dtypes import DataType
    from spark_rapids_tpu_torch.io import orc_device as OD
    from spark_rapids_tpu_torch.io import orc_meta as OM

    def image(rows, streams, encodings):
        buf, locs = bytearray(), []
        for kind, cid, payload in streams:
            locs.append(OM.StreamLoc(kind, cid, len(buf), len(payload)))
            buf += payload
        return OM.StripeImage(np.frombuffer(bytes(buf) or b"\0", np.uint8),
                              locs, encodings, "UTC", rows)

    def lits(bits):
        return byte_rle([("lit", bytes(np.packbits(bits)[i:i + 128]))
                         for i in range(0, (len(bits) + 7) // 8, 128)])

    rows = 1000
    valid = rng.random(rows) < 0.8
    n = int(valid.sum())
    pres = lits(valid)
    secs = [int(x) for x in rng.integers(-2 * 10**9, 10**9, n)]
    nanos = [int(x) for x in rng.integers(0, 10**9, n)]


    cols = [
        (DataType.BOOL, 0, [(1, lits(rng.random(n) < 0.5))]),
        (DataType.INT16, 2, [(1, rle_direct([int(x) for x in rng.integers(
            -2**15, 2**15, n)], 16, True))]),
        (DataType.INT32, 2, [(1, rle_direct([int(x) for x in rng.integers(
            -2**31, 2**31, n)], 32, True))]),
        (DataType.FLOAT32, 0, [(1, rng.standard_normal(n).astype(
            "<f4").tobytes())]),
        (DataType.FLOAT64, 0, [(1, rng.standard_normal(n).astype(
            "<f8").tobytes())]),
        (DataType.STRING, 2, [(1, b"ab" * n), (2, rle_direct(
            [2] * n, 2, False))]),
        (DataType.STRING, 3, [(1, rle_direct([int(x) for x in rng.integers(
            0, 3, n)], 2, False)), (2, rle_direct([0, 1, 3], 2, False)),
            (3, b"xyyzzz")]),
        (DataType.TIMESTAMP, 2, [(1, rle_direct(secs, 64, True)),
                                 (5, rle_direct([orc_nano_code(v) for v in
                                                 nanos], 64, False))]),
    ]
    count = 0
    for i, (dt, enc, streams) in enumerate(cols):
        encs = {0: (0, 0), 1: (enc, 3 if enc == 3 else 0)}
        img = image(rows, [(0, 1, pres)] + [(k, 1, p) for k, p in streams],
                    encs)
        plan = OD.plan_column(img, 1, dt, f"edge {dt.name}")
        cap = bucket_capacity(rows)
        got = OD.decode_column(plan, torch.from_numpy(img.buf.copy()).to(
            dev), cap, img.buf)
        want = OD.decode_column(plan, torch.from_numpy(img.buf.copy()), cap,
                                img.buf)
        check(torch.equal(got.validity.cpu(), want.validity),
              f"orc stripe {dt.name} ({i}): validity differs")
        if dt is DataType.STRING:
            check(torch.equal(got.offsets.cpu(), want.offsets) and
                  torch.equal(got.data[:int(want.offsets[-1])].cpu(),
                              want.data[:int(want.offsets[-1])]),
                  f"orc stripe STRING ({i}): values differ")
        else:
            check(torch.equal(got.data.cpu().view(torch.uint8),
                              want.data.view(torch.uint8)),
                  f"orc stripe {dt.name} ({i}): values differ")
        count += 1
    # an all-NULL INT column, and a stripe of no rows
    for r, p in ((rows, lits(np.zeros(rows, bool))), (0, b"")):
        img = image(r, [(0, 1, p), (1, 1, b"")], {0: (0, 0), 1: (2, 0)})
        plan = OD.plan_column(img, 1, DataType.INT32, "edge all NULL")
        cap = bucket_capacity(max(r, 1))
        got = OD.decode_column(plan, torch.from_numpy(img.buf.copy()).to(
            dev), cap, img.buf)
        check(not bool(got.validity.any()) and not bool(
            got.data.any()), f"orc stripe of {r} NULL rows: not all NULL")
        count += 1
    return count


def time_orc_kernels(dev, errs: dict) -> dict:
    """K27-K29 and K22's ORC mode at the SF 10 lineitem stripe shape (one
    15M-row stripe, as df.write.orc writes a partition): K29 encoding
    l_shipdate-like dates (99% present) and K27 expanding its stream back,
    K28 expanding the PRESENT stream of that column, K22's ORC mode
    compacting l_extendedprice-like DOUBLEs; beside them K27 over one
    Hive-layout stripe's l_returnflag index stream (2^21 rows: SHORT_REPEAT
    and DIRECT runs). Each is checked against its plain version there, bit
    for bit. A bound counts each input read once and each output written
    once (run tables at their bytes)."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.columnar import batch as CBT
    from spark_rapids_tpu_torch.columnar.dtypes import DataType
    from spark_rapids_tpu_torch.io import orc_device as OD
    from spark_rapids_tpu_torch.io import orc_encode_device as OE
    from spark_rapids_tpu_torch.io import parquet_encode_device as PE

    n = ORC_SHAPE_ROWS
    cap = CBT.bucket_capacity(n)
    rng = np.random.default_rng(67)
    iters, plain_iters = KERNEL_ITERS, PLAIN_ITERS
    rows = {}
    dates = torch.from_numpy(rng.integers(8035, 10561, cap).astype(
        np.int32)).to(dev)
    valid = torch.from_numpy(rng.random(cap) < 0.99).to(dev)
    compare_k29(dates, valid, n, True, "K29 15M dates", errs)
    stream, present, counts = OE.encode_direct(dates, valid, n, True)
    live, width, nbytes = counts.tolist()
    rows["orc_encode_direct"] = dict(
        ms=cuda_ms(lambda: OE.encode_direct(dates, valid, n, True), iters),
        plain_ms=cuda_ms(lambda: OE.encode_direct_plain(dates, valid, n,
                                                        True), plain_iters),
        library_ms=None,
        bound_ms=bound_ms(4 * n + n + nbytes + cap // 8 + 24),
        shape=f"{n} DATE rows like l_shipdate, {live} live, width {width}, "
              f"{nbytes} stream bytes")
    s_np = stream[:nbytes].cpu().numpy()
    rt = OD.parse_rlev2(s_np, 0, nbytes, live, True)
    buf = stream[:nbytes].contiguous()
    drt = OD.device_rlev2(rt, dev)
    cap_p = CBT.bucket_capacity(live)
    got = OD.rlev2_expand(buf, drt, cap_p)
    want = OD.rlev2_expand_plain(buf, drt, cap_p)
    check(torch.equal(got, want), "K27 15M dates: differs from its plain "
          "version")
    dense = dates[:n][valid[:n]].long()
    check(torch.equal(got[:live], dense), "K27 15M dates: not the values "
          "K29 encoded")
    runs = len(rt.kind)
    hive = rng.integers(0, 3, ORC_HIVE_STRIPE_ROWS)
    hbuf, hkinds = rlev2_encode(hive, False)
    hnp = np.frombuffer(hbuf, np.uint8)
    hrt = OD.parse_rlev2(hnp, 0, len(hbuf), len(hive), False)
    hdev = torch.from_numpy(hnp.copy()).to(dev)
    hdrt = OD.device_rlev2(hrt, dev)
    hcap = CBT.bucket_capacity(len(hive))
    check(torch.equal(OD.rlev2_expand(hdev, hdrt, hcap),
                      OD.rlev2_expand_plain(hdev, hdrt, hcap)),
          "K27 hive flags: differs from its plain version")
    rows["rlev2_expand"] = dict(
        ms=cuda_ms(lambda: OD.rlev2_expand(buf, drt, cap_p), iters),
        plain_ms=cuda_ms(lambda: OD.rlev2_expand_plain(buf, drt, cap_p),
                         plain_iters),
        library_ms=None,
        bound_ms=bound_ms(nbytes + 38 * runs + 8 * cap_p),
        ms_hive=cuda_ms(lambda: OD.rlev2_expand(hdev, hdrt, hcap), iters),
        plain_ms_hive=cuda_ms(lambda: OD.rlev2_expand_plain(hdev, hdrt,
                                                            hcap),
                              plain_iters),
        bound_ms_hive=bound_ms(len(hbuf) + 38 * len(hrt.kind) + 8 * hcap),
        shape=f"{live} DATE values in {runs} DIRECT runs of width {width} "
              f"(hive: {len(hive)} flag indices in {len(hrt.kind)} runs, "
              f"{hkinds})")
    pbytes = OE._present_stream(present[:(n + 7) // 8].cpu().numpy()
                                .tobytes())
    pnp = np.frombuffer(pbytes, np.uint8)
    bt = OD.parse_byte_rle(pnp, 0, len(pbytes), n)
    pdev = torch.from_numpy(pnp.copy()).to(dev)
    dbt = OD.device_byte_rle(bt, dev)
    compare_k28(pbytes, cap, "K28 15M PRESENT", errs, dev)
    check(torch.equal(OD.present_expand(pdev, dbt, cap)[:n], valid[:n]),
          "K28 15M PRESENT: not the validity K29 packed")
    rows["present_expand"] = dict(
        ms=cuda_ms(lambda: OD.present_expand(pdev, dbt, cap), iters),
        plain_ms=cuda_ms(lambda: OD.present_expand_plain(pdev, dbt, cap),
                         plain_iters),
        library_ms=None,
        bound_ms=bound_ms(len(pbytes) + 22 * len(bt.count) + cap),
        shape=f"{n} rows' PRESENT stream ({len(bt.count)} literal runs)")
    price = torch.from_numpy(rng.random(cap) * 1e5).to(dev)
    pvalid = torch.arange(cap, device=dev) < n
    pcol = CBT.ColumnVector(DataType.FLOAT64, price, pvalid)
    compare_k30(pcol, n, "K22 ORC mode 15M DOUBLE", errs)
    rows["orc_pack_present"] = dict(
        ms=cuda_ms(lambda: PE.encode_plain_page(pcol, n, orc=True), iters),
        plain_ms=cuda_ms(lambda: PE.encode_plain_page_plain(pcol, n,
                                                            orc=True),
                         plain_iters),
        library_ms=cuda_ms(lambda: price[pvalid], plain_iters),
        bound_ms=bound_ms(n + 8 * n + 8 * n + cap // 8 + 16),
        shape=f"{n} DOUBLE rows like l_extendedprice")
    return rows


# ------------------------------------------- memory phase 13 (slice 11)
# K31 / K32 over every fixed lane type: (name, numpy dtype name)
MEMORY_DTYPES = (("BOOL", "bool"), ("INT8", "int8"), ("INT16", "int16"),
                 ("INT32", "int32"), ("INT64", "int64"),
                 ("FLOAT", "float32"), ("DOUBLE", "float64"),
                 ("DATE", "int32"), ("TIMESTAMP", "int64"),
                 ("DECIMAL(18,4)", "int64"), ("codes", "int32"))
# one lineitem partition at SF 10 under q1's filter (l_shipdate <=
# 1998-09-02); lineitem's fixed columns: four int64 keys, l_linenumber
# int32, four DOUBLEs, three DATEs
K31_ROWS = 15_000_000
LINEITEM_FIXED = ("int64", "int64", "int64", "int32", "float64", "float64",
                  "float64", "float64", "int32", "int32", "int32")
# phase 13(c): the injected-fault runs' scale factor and rates
SPLIT_SF = 1
SPLIT_RATE = 0.6
FALLBACK_RATE = 1.0
Q1_COLUMNS = ("l_returnflag", "l_linestatus", "l_quantity",
              "l_extendedprice", "l_discount", "l_tax", "l_shipdate")
# phase 13(b): the host tier takes what the OOM's spills move (the disk
# tier is 13(a)'s to show)
OOM_HOST_TIER = 32 << 30


def memory_column(rng, tdt: str, cap: int, n: int, dev):
    """(data, validity) [cap] of one fixed column in the batch invariant:
    NULLs and lanes past n hold 0."""
    import numpy as np
    import torch

    npdt = np.dtype(tdt)
    if npdt == np.bool_:
        data = rng.random(cap) < 0.5
    elif np.issubdtype(npdt, np.floating):
        data = (rng.standard_normal(cap) * 1e3).astype(npdt)
        data[::7] = np.nan
    else:
        info = np.iinfo(npdt)
        data = rng.integers(info.min, info.max, cap, dtype=npdt,
                            endpoint=True)
    valid = (rng.random(cap) < 0.8) & (np.arange(cap) < n)
    data[~valid] = 0
    return (torch.from_numpy(data).to(dev), torch.from_numpy(valid).to(dev))


def compare_k31(pieces, lives, cap_out: int, label: str, errs: dict):
    """K31 against its plain version on the same inputs, bit for bit."""
    from spark_rapids_tpu_torch.columnar import batch as CBT

    got, n = CBT.compact_fixed(pieces, lives, cap_out)
    want, wn = CBT.compact_fixed_plain(pieces, lives, cap_out)
    check(int(n) == int(wn), f"{label}: K31 kept {int(n)}, plain {int(wn)}")
    for k, (g, w) in enumerate(zip(got, want)):
        check(bits_equal(g, w), f"{label}: K31 column {k} differs from its "
              "plain version")
    errs.setdefault("compact_fixed", 0.0)


def compare_k32(datas, valids, idx, out_rows: int, ivalid, cap: int,
                label: str, errs: dict):
    """K32 against its plain version on the same inputs, bit for bit."""
    from spark_rapids_tpu_torch.columnar import batch as CBT

    got = CBT.gather_fixed(datas, valids, idx, out_rows, ivalid, cap)
    want = CBT.gather_fixed_plain(datas, valids, idx, out_rows, ivalid, cap)
    for k, ((gd, gv), (wd, wv)) in enumerate(zip(got, want)):
        check(bits_equal(gd, wd) and bits_equal(gv, wv),
              f"{label}: K32 column {k} differs from its plain version")
    errs.setdefault("gather_fixed", 0.0)


def memory_edge_cases(dev, errs: dict) -> int:
    """K31 and K32 bit for bit against their plain versions: every fixed
    lane type (BOOL, INT8-64, FLOAT, DOUBLE, DATE, TIMESTAMP, DECIMAL,
    encoded codes), 0 rows, none kept, all kept, a kept tail, int32 and
    int64 indices that are out of range, negative or masked off, an index
    vector and a mask shorter than the output, a multi-piece concat (an
    empty piece among them), and tiles that are full, partial and many."""
    import numpy as np
    import torch

    rng = np.random.default_rng(131)
    count = 0
    for rows, cap in ((0, 8), (5, 8), (3000, 4096), (70_000, 1 << 17)):
        cols = [memory_column(rng, t, cap, rows, dev)
                for _, t in MEMORY_DTYPES]
        piece = [t for c in cols for t in c]
        lane = torch.arange(cap, device=dev)
        for kind in ("random", "none", "all", "tail"):
            keep = {"random": torch.from_numpy(rng.random(cap) < 0.4).to(dev),
                    "none": torch.zeros(cap, dtype=torch.bool, device=dev),
                    "all": torch.ones(cap, dtype=torch.bool, device=dev),
                    "tail": lane >= max(rows - 3, 0)}[kind] & (lane < rows)
            compare_k31([piece], [keep], cap, f"K31 {rows} rows {kind}",
                        errs)
            count += 1
        out_rows = max(rows, 1) + 7
        ocap = 1 << max(3, (out_rows - 1).bit_length())
        iv = None
        for itype in (np.int32, np.int64):
            idx = torch.from_numpy(rng.integers(-3, cap + 3, ocap).astype(
                itype)).to(dev)
            for masked in (False, True):
                iv = torch.from_numpy(rng.random(ocap) < 0.7).to(dev) \
                    if masked else None
                compare_k32([c[0] for c in cols], [c[1] for c in cols], idx,
                            out_rows, iv, ocap,
                            f"K32 {rows} rows {itype.__name__}", errs)
                count += 1
        compare_k32([c[0] for c in cols], [c[1] for c in cols],
                    idx[:ocap // 2], out_rows, iv[:ocap // 4], ocap,
                    f"K32 {rows} rows short indices", errs)
        count += 1
    caps, rows = (1024, 8, 4096 * 3 + 5, 512), (1000, 0, 4096 * 3, 300)
    pieces, lives = [], []
    for cap, n in zip(caps, rows):
        cols = [memory_column(rng, t, cap, n, dev) for _, t in MEMORY_DTYPES]
        pieces.append([t for c in cols for t in c])
        lives.append(torch.from_numpy((rng.random(cap) < 0.5) &
                                      (np.arange(cap) < n)).to(dev))
    cap_out = 1 << (sum(caps) - 1).bit_length()
    compare_k31(pieces, lives, cap_out, "K31 four-piece concat", errs)
    return count + 1


def time_memory_kernels(dev, errs: dict) -> dict:
    """K31 on one 15M-row lineitem partition's fixed columns under q1's
    filter mask, and on the half split-and-retry gives (7.5M rows); K32 at
    q5's join emit (the stream side's l_orderkey, l_suppkey,
    l_extendedprice, l_discount gathered by 2^22 matched rows of a
    2^22-row stream batch, JOIN_SHAPE) and as the slice that makes a half.
    Each is checked against its plain version there, bit for bit. Bound:
    K31 reads the mask and every column once and writes the kept rows;
    K32 reads the indices and the gathered lanes and writes every output
    lane. Library: `data[mask]` (K31) and `index_select` (K32) over the
    columns and their validity."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.columnar import batch as CBT

    iters, plain_iters = KERNEL_ITERS, PLAIN_ITERS
    rng = np.random.default_rng(137)
    n = K31_ROWS
    cap = CBT.bucket_capacity(n)
    cols = [memory_column(rng, t, cap, n, dev) for t in LINEITEM_FIXED]
    piece = [t for c in cols for t in c]
    lane = torch.arange(cap, device=dev)
    shipdate = torch.from_numpy(rng.integers(8035, 10561, cap).astype(
        np.int32)).to(dev)
    mask = (shipdate <= 10471) & (lane < n)  # 1998-09-02
    kept = int(mask.sum())
    compare_k31([piece], [mask], cap, "K31 15M lineitem", errs)
    widths = sum(t.element_size() + 1 for t, _ in cols)

    def k31_bytes(lanes, kept_rows):
        return lanes + widths * lanes + widths * kept_rows

    half = n // 2
    hcap = CBT.bucket_capacity(n - half)
    hidx = torch.arange(half, half + hcap, device=dev)
    halves = CBT.gather_fixed([c[0] for c in cols], [c[1] for c in cols],
                              hidx, n - half, None, hcap)
    hpiece = [t for d, v in halves for t in (d, v)]
    hmask = (shipdate[half:half + hcap] <= 10471) & (
        torch.arange(hcap, device=dev) < n - half)
    hkept = int(hmask.sum())
    compare_k31([hpiece], [hmask], hcap, "K31 split half", errs)
    compare_k32([c[0] for c in cols], [c[1] for c in cols], hidx, n - half,
                None, hcap, "K32 split half", errs)

    def lib_compact(ts, m):
        return [t[m] for t in ts]

    rows = {"compact_fixed": dict(
        ms=cuda_ms(lambda: CBT.compact_fixed([piece], [mask], cap), iters),
        plain_ms=cuda_ms(lambda: CBT.compact_fixed_plain([piece], [mask],
                                                         cap), plain_iters),
        library_ms=cuda_ms(lambda: lib_compact(piece, mask), plain_iters),
        bound_ms=bound_ms(k31_bytes(cap, kept)),
        ms_half=cuda_ms(lambda: CBT.compact_fixed([hpiece], [hmask], hcap),
                        iters),
        plain_ms_half=cuda_ms(lambda: CBT.compact_fixed_plain(
            [hpiece], [hmask], hcap), plain_iters),
        library_ms_half=cuda_ms(lambda: lib_compact(hpiece, hmask),
                                plain_iters),
        bound_ms_half=bound_ms(k31_bytes(hcap, hkept)),
        shape=f"{n} rows x {len(cols)} fixed columns (lineitem's), "
              f"{kept} kept by q1's filter; half: {n - half} rows, {hkept} "
              f"kept")}
    _, s_rows, _ = JOIN_SHAPE
    out_rows = s_rows
    ocap = CBT.bucket_capacity(out_rows)
    scols = [memory_column(rng, t, s_rows, s_rows, dev)
             for t in ("int64", "int64", "float64", "float64")]
    # the matched stream rows in stream order, some repeated (join_expand)
    sidx = torch.sort(torch.from_numpy(rng.integers(
        0, s_rows, ocap).astype(np.int32)).to(dev)).values
    compare_k32([c[0] for c in scols], [c[1] for c in scols], sidx,
                out_rows, None, ocap, "K32 q5 join emit", errs)
    swidth = sum(d.element_size() + 1 for d, _ in scols)

    def lib_gather(ts, idx):
        return [t.index_select(0, idx) for t in ts]

    sflat = [t for c in scols for t in c]
    rows["gather_fixed"] = dict(
        ms=cuda_ms(lambda: CBT.gather_fixed(
            [c[0] for c in scols], [c[1] for c in scols], sidx, out_rows,
            None, ocap), iters),
        plain_ms=cuda_ms(lambda: CBT.gather_fixed_plain(
            [c[0] for c in scols], [c[1] for c in scols], sidx, out_rows,
            None, ocap), plain_iters),
        library_ms=cuda_ms(lambda: lib_gather(sflat, sidx), plain_iters),
        bound_ms=bound_ms(4 * ocap + 2 * swidth * ocap),
        ms_half=cuda_ms(lambda: CBT.gather_fixed(
            [c[0] for c in cols], [c[1] for c in cols], hidx, n - half, None,
            hcap), iters),
        plain_ms_half=cuda_ms(lambda: CBT.gather_fixed_plain(
            [c[0] for c in cols], [c[1] for c in cols], hidx, n - half, None,
            hcap), plain_iters),
        library_ms_half=cuda_ms(lambda: lib_gather(piece, hidx), plain_iters),
        bound_ms_half=bound_ms(8 * hcap + 2 * widths * hcap),
        shape=f"{out_rows} rows x {len(scols)} stream columns of a "
              f"{s_rows}-row batch (q5's emit); half: {n - half} rows x "
              f"{len(cols)} lineitem columns")
    return rows


def table_device_bytes(df) -> int:
    """The device bytes a host table takes once uploaded: every column at
    its partition's bucketed capacity (strings: offsets, bytes, validity)."""
    from spark_rapids_tpu_torch.columnar.batch import bucket_capacity

    total = 0
    for part in df._plan.partitions:
        for b in part:
            cap = bucket_capacity(b.num_rows)
            for c in b.columns:
                if c.dtype.is_string:
                    nbytes = int(c.utf8()[0][b.num_rows])
                    total += 4 * (cap + 1) + bucket_capacity(
                        max(nbytes, 1)) + cap
                else:
                    total += (c.dtype.to_np().itemsize + 1) * cap
    return total


def in_session(sess, tables: dict, names) -> dict:
    """Host tables as DataFrames of another session, cached there."""
    from spark_rapids_tpu_torch.plan.dataframe import DataFrame

    return {k: DataFrame(tables[k]._plan, sess).cache() for k in names}


def memory_totals() -> dict:
    from spark_rapids_tpu_torch.utils import metrics as M

    return {k: M.total(k) for k in (M.SPILL_TO_HOST_BYTES,
                                    M.SPILL_TO_DISK_BYTES, M.UNSPILLS,
                                    M.RETRIES, M.SPLIT_RETRIES,
                                    M.CPU_FALLBACK_EVENTS)}


def memory_delta(before: dict) -> dict:
    now = memory_totals()
    return {k: now[k] - before[k] for k in now}


def run_memory_spill(raw, wants: dict, launches: dict) -> dict:
    """Phase 13(a): phase 4's SF 10 host tables of q1-q5 cached in a session
    whose device budget (hbm.sizeOverride, allocFraction 1) is half their
    device bytes and whose host tier holds a quarter of them, then q5 and
    q1 once each against phases 5's and 4's numpy rows: cached batches
    spill device -> host -> disk and come back."""
    import shutil
    import tempfile

    import torch

    import spark_rapids_tpu_torch as srt
    from spark_rapids_tpu_torch import cuda_build as CB
    from spark_rapids_tpu_torch.benchmarks import tpch

    dev_bytes = sum(table_device_bytes(raw[k]) for k in PARQUET_TABLES)
    spill_dir = tempfile.mkdtemp(prefix="chip-smoke-spill-")
    sess = srt.new_session(dict(TPCH_CONF, **{
        "rapids.tpu.memory.hbm.sizeOverride": dev_bytes // 2,
        "rapids.tpu.memory.hbm.allocFraction": 1.0,
        "rapids.tpu.memory.host.spillStorageSize": dev_bytes // 4,
        "rapids.tpu.memory.spill.dir": spill_dir}))
    out = {"tables_device_bytes": dev_bytes,
           "budget": sess.spill.watermark.budget,
           "host_tier_bytes": dev_bytes // 4}
    try:
        tables = in_session(sess, raw, PARQUET_TABLES)
        before = memory_totals()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for q in ("q5", "q1"):
            name = f"memory_spill_{q}"
            q_before = memory_totals()
            CB.reset_launch_counts()
            out[name] = run_query(sess, tpch.QUERIES[q](tables),
                                  wants[f"tpch_{q}"], name, 0,
                                  faults_ok=True)
            launches[name] = CB.launch_counts()
            out[name]["metrics"] = memory_delta(q_before)
            log(f"{name}: {out[name]['metrics']}")
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
        out["metrics"] = memory_delta(before)
        out["tiers"] = sess.spill.snapshot()
        m = out["metrics"]
        check(m["spillDeviceToHostBytes"] > 0 and
              m["spillHostToDiskBytes"] > 0,
              f"phase 13(a): both spill tiers must be used: {m}")
        check(m["spillRematerializations"] > 0,
              f"phase 13(a): no spilled batch came back: {m}")
        log(f"phase 13(a): tables {dev_bytes} device bytes, budget "
            f"{out['budget']}, peak {out['peak_bytes']}: {m}; "
            f"tiers {out['tiers']}")
        for df in tables.values():
            df.unpersist()
    finally:
        sess.stop()
        shutil.rmtree(spill_dir, ignore_errors=True)
    return out


def run_memory_oom(raw, wants: dict, launches: dict) -> dict:
    """Phase 13(b): lineitem's q1 columns cached on the card (the default
    budget);
    after empty_cache a ballast tensor leaves free only half of what q1's
    warm run needed above its cached table, so q1 runs out of device
    memory: the CUDA OutOfMemoryError becomes TpuRetryOOM, spills the
    device store, and q1 runs again to numpy's rows."""
    import shutil
    import tempfile

    import torch

    import spark_rapids_tpu_torch as srt
    from spark_rapids_tpu_torch import cuda_build as CB
    from spark_rapids_tpu_torch.benchmarks import tpch
    from spark_rapids_tpu_torch.plan.dataframe import DataFrame

    spill_dir = tempfile.mkdtemp(prefix="chip-smoke-oom-")
    sess = srt.new_session(dict(TPCH_CONF, **{
        "rapids.tpu.execution.retry.oomRetries": 4,
        "rapids.tpu.memory.host.spillStorageSize": OOM_HOST_TIER,
        "rapids.tpu.memory.spill.dir": spill_dir}))
    out = {}
    try:
        li = DataFrame(raw["lineitem"]._plan, sess).select(*Q1_COLUMNS)
        tables = {"lineitem": li.cache()}
        q = tpch.q1(tables)
        q.collect()  # caches lineitem's q1 columns on the card
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        check_rows(q.collect(), wants["tpch_q1"], "memory_oom_q1 warm")
        torch.cuda.synchronize()
        need = torch.cuda.max_memory_allocated() - base
        torch.cuda.empty_cache()
        free, _ = torch.cuda.mem_get_info()
        leave = need // 2
        ballast = torch.empty(max(free - leave, 0), dtype=torch.uint8,
                              device="cuda")
        out.update(cached_bytes=base, q1_needs_bytes=need,
                   free_before_ballast=free, ballast_bytes=ballast.numel(),
                   left_free=leave)
        log(f"phase 13(b): ballast {ballast.numel()} bytes leaves {leave} "
            f"free; q1 needed {need} above its {base} cached")
        before = memory_totals()
        CB.reset_launch_counts()
        try:
            out["memory_oom_q1"] = run_query(sess, q, wants["tpch_q1"],
                                             "memory_oom_q1", 0,
                                             faults_ok=True)
        finally:
            del ballast
        launches["memory_oom_q1"] = CB.launch_counts()
        out["metrics"] = memory_delta(before)
        log(f"phase 13(b): {out['metrics']}")
        check(out["metrics"]["retries"] >= 1,
              f"phase 13(b): q1 ran without a retry: {out['metrics']}")
        for df in tables.values():
            df.unpersist()
    finally:
        sess.stop()
        shutil.rmtree(spill_dir, ignore_errors=True)
    return out


def escalating_seed(rate: float) -> int:
    """A fault-injection seed whose first three 'filter' rolls inject (the
    first batch spends both OOM retries and bisects) and not all of whose
    next nine do (the halves get through): the decision the JAX package
    makes too. The PRF is a CRC, so runs of injections are rarer than the
    rate alone suggests."""
    from spark_rapids_tpu_torch.utils import faultinject as FI

    for seed in range(10_000):
        inj = FI.FaultInjector(seed, "filter", rate)
        rolls = [inj.decide("filter", i) for i in range(12)]
        if all(rolls[:3]) and not all(rolls[3:]):
            return seed
    raise SmokeFailure("no escalating seed")


def run_memory_faults(launches: dict) -> dict:
    """Phase 13(c): TPC-H q1 at SF 1 (lineitem cached with q1's columns)
    with fusion off (its filter and project run as operators) under the
    reference's fault-injection keys at the filter and project sites:
    first at SPLIT_RATE with a seed whose first
    filter batch bisects (K32 slices the halves, K31 compacts them), then at
    FALLBACK_RATE at the filter site, where every filter batch exhausts its
    device retries and runs on the CPU engine, and the circuit breaker
    opens (and, the query complete, closes again). Rows against numpy each
    time."""
    import shutil
    import tempfile

    import torch

    import spark_rapids_tpu_torch as srt
    from spark_rapids_tpu_torch import cuda_build as CB
    from spark_rapids_tpu_torch.benchmarks import tpch

    seed = escalating_seed(SPLIT_RATE)
    spill_dir = tempfile.mkdtemp(prefix="chip-smoke-faults-")
    sess = srt.new_session(dict(TPCH_CONF, **{
        "rapids.tpu.memory.spill.dir": spill_dir,
        "rapids.tpu.sql.fusion.enabled": False,
        "rapids.tpu.engine.retryBackoffMs": 0.0,
        "rapids.tpu.test.faultInjection.enabled": True,
        "rapids.tpu.test.faultInjection.sites": "filter,project",
        "rapids.tpu.test.faultInjection.rate": SPLIT_RATE,
        "rapids.tpu.test.faultInjection.seed": seed}))
    out = {"sf": SPLIT_SF, "seed": seed}
    try:
        raw = tpch.gen_tables(sess, sf=SPLIT_SF,
                              num_partitions=TPCH_PARTITIONS)
        want = numpy_q1(lineitem_columns(raw["lineitem"]))
        # q1's columns only: a CPU fallback moves what the query reads
        tables = {"lineitem": raw["lineitem"].select(*Q1_COLUMNS).cache()}
        for name, sites, rate in (
                ("memory_split", "filter,project", SPLIT_RATE),
                ("memory_fallback", "filter", FALLBACK_RATE)):
            sess.set_conf("rapids.tpu.test.faultInjection.sites", sites)
            sess.set_conf("rapids.tpu.test.faultInjection.rate", rate)
            before = memory_totals()
            CB.reset_launch_counts()
            out[name] = run_query(sess, tpch.q1(tables), want, name, 0,
                                  faults_ok=True)
            launches[name] = CB.launch_counts()
            out[name]["metrics"] = memory_delta(before)
            # a device query that completes closes a tripped breaker
            # (note_success, as the reference's session): its transitions
            # show that it opened
            out[name]["breaker"] = sess.breaker.transitions()
            log(f"{name} (rate {rate}): {out[name]['metrics']}, breaker "
                f"{out[name]['breaker']}")
        m = out["memory_split"]["metrics"]
        check(m["splitRetries"] >= 1, f"phase 13(c): no split: {m}")
        m = out["memory_fallback"]["metrics"]
        check(m["cpuFallbackEvents"] >= 1 and
              out["memory_fallback"]["breaker"]["opened"] >= 1,
              f"phase 13(c): no fallback or the breaker never opened: {m}")
        for df in tables.values():
            df.unpersist()
    finally:
        sess.stop()
        shutil.rmtree(spill_dir, ignore_errors=True)
        torch.cuda.empty_cache()
    return out


def run_memory(raw, wants: dict, launches: dict) -> dict:
    """Phase 13: (a) spill under a budget, (b) a real CUDA OOM, (c) injected
    splits and CPU fallback."""
    return {"spill": run_memory_spill(raw, wants, launches),
            "oom": run_memory_oom(raw, wants, launches),
            "faults": run_memory_faults(launches)}


# ------------------------------------------------- phase 14 (slice 12)
# TPC-H over CSV: the six q1-q5 tables at CSV_SF (SF 10's lineitem would
# be ~6.6 GB of text), CSV_PARTITIONS files a table (~175 MB a lineitem
# file, under the 256 MiB split limit), written and read with sep '|' and
# no header, as TPC-H's generator lays its text out
CSV_SF = 3
CSV_PARTITIONS = 12
# warm runs a query: 0, the first cut that pays for the phase (a CSV run
# reads its files again, so a warm run is one more cold read)
CSV_WARM_REPS = 0
# a file one batch, as a cached partition is, so the float sums add in the
# cached tables' order and the rows equal theirs bit for bit
CSV_CONF = dict(TPCH_CONF, **{"rapids.tpu.sql.reader.batchSizeRows": 1 << 21})
CSV_INT_EDGES = [
    b"", b"0", b"-0", b"7", b"007", b"9223372036854775807",
    b"9223372036854775808", b"-9223372036854775808", b"-9223372036854775807",
    b"1234567890123456789", b"12345678901234567890", b"+5", b" 5", b"-",
    b"1.0", b"1e5", b"NA", b"127", b"128", b"-128", b"-129", b"32767",
    b"32768", b"-32769", b"2147483647", b"2147483648", b"-2147483649"]
CSV_FLOAT_EDGES = [
    b"", b"0", b"-0", b"17", b"0.07", b"-1.5", b".5", b"5.", b"-.5", b".",
    b"1..2", b"1e5", b"inf", b"nan", b"+1.5", b"123456789012345",
    b"1234567890123456", b"99999.99", b"0.1234567890123456789012",
    b"0.12345678901234567890123", b"0.0000000000000000000001",
    b"12345678.90123456", b"-999999999999999"]
CSV_DATE_EDGES = [
    b"", b"2020-01-01", b"2000-02-29", b"1900-02-29", b"2023-02-30",
    b"0000-01-01", b"9999-12-31", b"2020-1-01", b"2020-01-01 ", b"2020-13-01",
    b"2020-01-00", b"NA"]
CSV_TS_EDGES = [
    b"", b"2020-01-01 01:02:03Z", b"2020-01-01T01:02:03Z",
    b"2020-01-01 01:02:03+05", b"2020-01-01 01:02:03+0530",
    b"2020-01-01 01:02:03+05:30", b"2020-01-01 01:02:03-05:30",
    b"2020-01-01 01:02:03.123456Z", b"2020-01-01 01:02:03.1234567Z",
    b"2020-01-01 01:02:03", b"2020-01-01 24:00:00Z",
    b"2020-01-01 01:02:03+24", b"2020-01-01 01:02:03+23:60",
    b"2020-01-01 01:02:03.Z", b"1969-12-31 23:59:59.999999Z"]


def csv_spans(fields, crlf: bool, trailing: bool, dev):
    """(raw, starts, lens) on `dev` of `fields` one a line; trailing=False:
    the last field ends at raw's last byte."""
    import numpy as np
    import torch

    nl = b"\r\n" if crlf else b"\n"
    raw = nl.join(fields) + (nl if trailing else b"")
    lens = np.array([len(f) for f in fields], dtype=np.int32)
    starts = np.concatenate(([0], np.cumsum(lens + len(nl))[:-1])).astype(
        np.int32)
    return (torch.frombuffer(bytearray(raw), dtype=torch.uint8).to(dev),
            torch.from_numpy(starts).to(dev), torch.from_numpy(lens).to(dev))


def compare_csv(kernel: str, raw, starts, lens, label: str, errs: dict,
                dtype=None, timestamp: bool = False) -> None:
    """One K33-K36 launch on the card against its plain version on the CPU
    over the same fields, bit for bit (values, validity, the flag)."""
    import torch

    from spark_rapids_tpu_torch.io import csv_device as CD

    cap = max(int(starts.shape[0]) + 5, 8)
    outs = []
    for d in (raw.device, torch.device("cpu")):
        r, st, ln = raw.to(d), starts.to(d), lens.to(d)
        flag = torch.zeros(1, dtype=torch.int32, device=d)
        if kernel == "csv_parse_int":
            got = CD.csv_parse_int(r, st, ln, cap, dtype, flag)
        elif kernel == "csv_parse_float":
            got = CD.csv_parse_float(r, st, ln, cap, flag)
        elif kernel == "csv_parse_datetime":
            got = CD.csv_parse_datetime(r, st, ln, cap, timestamp, flag)
        else:
            got = (CD.csv_null_sentinels(r, st, ln, cap),)
        outs.append([t.cpu() for t in got] + [flag.cpu()])
    for a, b in zip(*outs):
        check(bits_equal(a, b), f"{kernel} {label}: differs from its plain "
              f"version: {a.tolist()} vs {b.tolist()}")
        errs[kernel] = max(errs.get(kernel, 0.0), max_abs_err(a, b))


def csv_edge_cases(dev, errs: dict) -> int:
    """K33-K36 against their plain versions bit for bit: the edge fields
    (empty and NULL-spelled, -0, int64 max, max + 1 and min, 19 and 20
    digits, narrow types out of range, 15 and 16 significant and 22 and 23
    fractional digits, 1e5, 2000-02-29, 1900-02-29, 2023-02-30, every zone
    form, 6 and 7 fraction digits) one a line, with LF and CRLF, and with
    the last field at raw's last byte; then a quoted CRLF file planned by
    the native sweep, each column through its kernel."""
    from spark_rapids_tpu_torch.columnar.dtypes import DataType
    from spark_rapids_tpu_torch.io import csv_device as CD

    n = 0
    for crlf in (False, True):
        for trailing in (True, False):
            tag = f"crlf={crlf} trailing={trailing}"
            spans = csv_spans(CSV_INT_EDGES, crlf, trailing, dev)
            for dt in (DataType.INT8, DataType.INT16, DataType.INT32,
                       DataType.INT64):
                compare_csv("csv_parse_int", *spans, f"{dt.name} {tag}",
                            errs, dtype=dt)
            compare_csv("csv_parse_float", *csv_spans(
                CSV_FLOAT_EDGES, crlf, trailing, dev), tag, errs)
            compare_csv("csv_parse_datetime", *csv_spans(
                CSV_DATE_EDGES, crlf, trailing, dev), tag, errs)
            compare_csv("csv_parse_datetime", *csv_spans(
                CSV_TS_EDGES, crlf, trailing, dev), tag, errs,
                timestamp=True)
            sentinels = [v.encode() for v in CD.NULL_VALUES] + [
                b"nul", b"NA ", b"null!", b"#N/A N/B", b"x"]
            compare_csv("csv_null_sentinels", *csv_spans(
                sentinels, crlf, trailing, dev), tag, errs)
            n += 8
    import numpy as np
    import torch

    text = (b'1,"NA",2020-01-01,"2020-01-01 01:02:03Z",1.5\r\n'
            b'"-7",NA,"2000-02-29",2020-01-01 01:02:03+05:30,"-0"\r\n'
            b',"",,,\r\n'
            b'"9223372036854775807","a,""b""",1900-02-29,,0.07')
    table = CD.plan_fields(np.frombuffer(text, dtype=np.uint8).copy(), 5,
                           False, ",")
    check(table is not None and table.num_rows == 4,
          "csv: the quoted CRLF fixture did not plan")
    raw = torch.from_numpy(table.raw.copy()).to(dev)
    for j, (kernel, kw) in enumerate((
            ("csv_parse_int", {"dtype": DataType.INT64}),
            ("csv_null_sentinels", {}), ("csv_parse_datetime", {}),
            ("csv_parse_datetime", {"timestamp": True}),
            ("csv_parse_float", {}))):
        st = torch.from_numpy(np.ascontiguousarray(table.starts[:, j])).to(dev)
        ln = torch.from_numpy(np.ascontiguousarray(table.lens[:, j])).to(dev)
        compare_csv(kernel, raw, st, ln, f"quoted CRLF column {j}", errs,
                    **kw)
        if kernel == "csv_null_sentinels":
            compare_csv("csv_parse_int", raw, st, ln, "quoted NA",
                        errs, dtype=DataType.INT32)
        n += 1
    return n


def time_csv_kernels(dev, errs: dict, path: str, names) -> dict:
    """K33-K36 at the path's own layout: one lineitem file that phase 14
    wrote (columns `names`, sep '|'), planned as the scan plans it. K33 on
    l_orderkey, K34 on l_extendedprice, K35 on l_shipdate, K36 on
    l_shipmode; K35's timestamp mode on the same text with
    ' 01:02:03.123456Z' after every l_shipdate (TPC-H has no TIMESTAMP
    column). Each beside its plain version on the card and its bound (the
    field bytes, starts and lengths read once, the values and validity
    written once). No PyTorch call parses decimal text: library_ms is
    null."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.columnar.dtypes import DataType
    from spark_rapids_tpu_torch.io import csv_device as CD

    table = CD.plan_fields(np.fromfile(path, dtype=np.uint8), len(names),
                           False, "|")
    check(table is not None, f"csv: {path} did not plan")
    n = table.num_rows
    cap = 1 << (n - 1).bit_length()
    raw = torch.from_numpy(table.raw).to(dev)
    flag = torch.zeros(1, dtype=torch.int32, device=dev)

    def col(name):
        j = names.index(name)
        return (torch.from_numpy(np.ascontiguousarray(table.starts[:, j]))
                .to(dev), torch.from_numpy(np.ascontiguousarray(
                    table.lens[:, j])).to(dev), table.field_bytes(j), j)

    rows = {}
    iters = 10
    specs = (
        ("csv_parse_int", "l_orderkey", lambda r, s, ln: CD.csv_parse_int(
            r, s, ln, cap, DataType.INT64, flag), CD.parse_int_plain, 9),
        ("csv_parse_float", "l_extendedprice",
         lambda r, s, ln: CD.csv_parse_float(r, s, ln, cap, flag),
         CD.parse_float_plain, 9),
        ("csv_parse_datetime", "l_shipdate",
         lambda r, s, ln: CD.csv_parse_datetime(r, s, ln, cap, False, flag),
         CD.parse_date_plain, 5),
        ("csv_null_sentinels", "l_shipmode",
         lambda r, s, ln: CD.csv_null_sentinels(r, s, ln, cap),
         CD.null_sentinels_plain, 1))
    shape = (f"one lineitem file: {n} rows of {len(names)} columns, "
             f"{table.raw.size} bytes")
    for name, column, fn, plain, out_bytes in specs:
        st, ln, fbytes, j = col(column)
        got = fn(raw, st, ln)
        want = plain(raw, st, ln)
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            check(bits_equal(a[:n], b), f"{name} at the lineitem layout: "
                  "differs from its plain version")
            errs[name] = max(errs.get(name, 0.0), max_abs_err(a[:n], b))
        rows[name] = dict(
            ms=cuda_ms(lambda: fn(raw, st, ln), iters),
            plain_ms=cuda_ms(lambda: plain(raw, st, ln), 2),
            library_ms=None,
            bound_ms=bound_ms(fbytes + 8 * n + out_bytes * n),
            shape=f"{shape}; {column} (column {j}), {fbytes} field bytes")
    check(int(flag.item()) == 0, "csv: a lineitem field was malformed")
    # the timestamp mode: the suffix inserted after each l_shipdate
    j = names.index("l_shipdate")
    suffix = np.frombuffer(b" 01:02:03.123456Z", dtype=np.uint8)
    k = suffix.size
    st = np.ascontiguousarray(table.starts[:, j]).astype(np.int64)
    ln = np.ascontiguousarray(table.lens[:, j])
    ts_raw = np.insert(table.raw, np.repeat(st + ln, k), np.tile(suffix, n))
    rt = torch.from_numpy(ts_raw).to(dev)
    st = torch.from_numpy((st + k * np.arange(n)).astype(np.int32)).to(dev)
    ln = torch.from_numpy(ln + k).to(dev)
    days = CD.csv_parse_datetime(raw, *col("l_shipdate")[:2], cap, False,
                                 flag)[0][:n]
    ts = lambda: CD.csv_parse_datetime(rt, st, ln, cap, True, flag)  # noqa
    got = ts()
    want = CD.parse_timestamp_plain(rt, st, ln)
    for a, b in zip(got, want):
        check(bits_equal(a[:n], b), "csv_parse_datetime timestamps at the "
              "lineitem layout: differ from the plain version")
    check(bool(got[1][:n].all()) and bool((got[0][:n] == days.long() *
          86_400_000_000 + 3_723_123_456).all()),
          "csv_parse_datetime: a lineitem timestamp parsed wrong")
    rows["csv_parse_datetime"].update(
        ms_timestamp=cuda_ms(ts, iters),
        plain_ms_timestamp=cuda_ms(lambda: CD.parse_timestamp_plain(
            rt, st, ln), 2),
        bound_ms_timestamp=bound_ms(int(ln.sum()) + 8 * n + 9 * n))
    check(int(flag.item()) == 0, "csv: a timestamp field was malformed")
    return rows


def csv_host_splits(sess) -> int:
    from spark_rapids_tpu_torch.io.scan import CSV_HOST_SPLITS, \
        TpuFileScanExec

    return sum(x.metrics.get(CSV_HOST_SPLITS, 0) for x in
               sess.last_physical_plan.collect_nodes(
                   lambda x: isinstance(x, TpuFileScanExec)))


def run_csv(launches: dict, dev, errs: dict) -> dict:
    """Phase 14: the six q1-q5 tables at CSV_SF generated (CSV_PARTITIONS
    partitions), written with df.write.csv (sep '|', no header; the seconds
    and bytes of each), K33-K36 timed over the first lineitem file
    (time_csv_kernels: "kernel_rows"), read back with
    read.schema(...).csv, and q1, q6,
    q3 and q5 over them (one cold and CSV_WARM_REPS warm runs, every leaf a
    TpuFileScanExec, no split through the host grammar) against numpy over
    the generated columns and against the same query over the tables
    cached on the card (bit for bit where both plans join alike, else
    within TPCH_REL); each query's scan host seconds beside its wall time.
    The files are removed at the end."""
    import glob
    import shutil
    import tempfile

    import torch

    import spark_rapids_tpu_torch as srt
    from spark_rapids_tpu_torch import cuda_build as CB
    from spark_rapids_tpu_torch.benchmarks import tpch

    sess = srt.new_session(CSV_CONF)
    t = time.perf_counter()
    raw = tpch.gen_tables(sess, sf=CSV_SF, num_partitions=CSV_PARTITIONS)
    gen_s = time.perf_counter() - t
    li = lineitem_columns(raw["lineitem"])
    o = table_columns(raw["orders"], ("o_orderkey", "o_custkey",
                                      "o_orderdate", "o_shippriority"))
    c = table_columns(raw["customer"], ("c_custkey", "c_mktsegment",
                                        "c_nationkey"))
    s = table_columns(raw["supplier"], ("s_suppkey", "s_nationkey"))
    n = table_columns(raw["nation"], ("n_nationkey", "n_regionkey",
                                      "n_name"))
    r = table_columns(raw["region"], ("r_regionkey", "r_name"))
    wants = {"q1": numpy_q1(li), "q6": numpy_q6(li),
             "q3": numpy_q3(li, o, c), "q5": numpy_q5(li, o, c, s, n, r)}
    n_li, n_ord = len(li["l_orderkey"]), len(o["o_orderkey"])
    n_cust, n_supp = len(c["c_custkey"]), len(s["s_suppkey"])
    input_rows = {"q1": n_li, "q6": n_li, "q3": n_li + n_ord + n_cust,
                  "q5": n_li + n_ord + n_cust + n_supp + 25 + 5}
    del li, o, c, s, n, r
    log(f"phase 14: SF {CSV_SF} generated in {gen_s:.1f} s, lineitem "
        f"{n_li} rows")
    root = tempfile.mkdtemp(prefix="chip_smoke_csv_")
    out = {"sf": CSV_SF, "gen_s": gen_s, "lineitem_rows": n_li,
           "write": {}}
    cached = {}
    try:
        for name in PARQUET_TABLES:
            path = os.path.join(root, name)
            t = time.perf_counter()
            raw[name].write.option("sep", "|").option("header", False) \
                .csv(path)
            secs = time.perf_counter() - t
            nbytes = sum(os.path.getsize(f) for f in
                         glob.glob(os.path.join(path, "*.csv")))
            out["write"][name] = {"s": secs, "bytes": nbytes,
                                  "mb_per_s": nbytes / secs / 1e6}
            log(f"csv: wrote {name} in {secs:.3f} s, {nbytes} bytes")
        first = sorted(glob.glob(os.path.join(root, "lineitem", "*.csv")))[0]
        out["kernel_rows"] = time_csv_kernels(
            dev, errs, first, [a.name for a in raw["lineitem"].schema])
        cached = {k: raw[k].cache() for k in PARQUET_TABLES}
        ctables = {k: sess.read.schema([(a.name, a.data_type)
                                        for a in raw[k].schema])
                   .option("sep", "|").csv(os.path.join(root, k))
                   for k in PARQUET_TABLES}
        for q in ("q1", "q6", "q3", "q5"):
            name = f"csv_tpch_{q}"
            query = tpch.QUERIES[q]
            want_cached = query(cached).collect()
            check_rows(want_cached, wants[q], f"{name} cached")
            cached_joins = [j["ran_as"] for j in join_strategies(sess)]
            CB.reset_launch_counts()
            res = run_query(sess, query(ctables), wants[q], name,
                            CSV_WARM_REPS, keep_rows=True)
            launches[name] = CB.launch_counts()
            assert_file_leaves(sess)
            host, splits = scan_host_s(sess), csv_host_splits(sess)
            joins = [j["ran_as"] for j in join_strategies(sess)]
            check(splits == 0, f"{name}: {splits} splits took the host "
                  "route")
            rows = res.pop("result_rows")
            if joins == cached_joins:
                check(rows == want_cached,
                      f"{name}: rows differ from the cached tables' run")
            else:
                # the planner knows a cached table's rows and no file's,
                # so the plans may join (and sum) in another order: the
                # rows agree with the cached run's within TPCH_REL (both
                # equal numpy within it above)
                log(f"{name}: joins {joins}, cached {cached_joins}: "
                    f"compared within a relative {TPCH_REL}")
                check_rows(rows, want_cached, f"{name} vs the cached run")
            warm = best_s(res)
            res.update(input_rows=input_rows[q],
                       rows_per_s=input_rows[q] / warm,
                       last_run_scan_host_s=host, csv_host_splits=splits,
                       joins=joins, cached_joins=cached_joins,
                       checked_against="numpy and the cached tables "
                                       "(bit for bit where the joins "
                                       "agree)")
            out[name] = res
            log(f"{name}: scan host {host:.3f} s of the last run "
                f"({last_s(res):.3f} s), "
                f"csvHostSplits {splits}, rows equal the cached run's")
    finally:
        shutil.rmtree(root, ignore_errors=True)
        for df in cached.values():
            df.unpersist()
        sess.last_physical_plan = None
        torch.cuda.empty_cache()
    return out



# ------------------------------------------------ phase 15 (slice 13)
# The string-cleaning programs over phase 4's cached tables: F is either
# package's functions module, so the CPU tests run the same text on both.
def strings_lineitem(t, F):
    """A composite key, rewritten literals and a padded mode, grouped."""
    return (t["lineitem"].select(
        F.concat_ws("|", "l_returnflag", "l_linestatus",
                    F.lower("l_shipmode")).alias("k"),
        F.regexp_replace("l_shipinstruct", "DELIVER IN PERSON",
                         "HAND").alias("how"),
        F.replace("l_shipinstruct", "COD", "CASH ON DELIVERY").alias("pay"),
        F.trim(F.concat(F.concat(F.lit("  "), F.col("l_shipmode")),
                        F.lit(" "))).alias("mode"),
        "l_extendedprice")
        .groupBy("k", "how", "pay", "mode")
        .agg(F.sum("l_extendedprice").alias("price"),
             F.count("*").alias("n")))


def strings_orders(t, F):
    """Codes split out of o_orderpriority ("4-NOT SPECIFIED" -> "4" and
    "Not Specified") and a case round trip, grouped."""
    return (t["orders"].select(
        F.initcap(F.lower(F.substring_index("o_orderpriority", "-",
                                            -1))).alias("name"),
        F.substring_index("o_orderpriority", "-", 1).alias("code"),
        F.upper(F.lower("o_orderstatus")).alias("status"),
        "o_totalprice")
        .groupBy("name", "code", "status")
        .agg(F.sum("o_totalprice").alias("price"), F.count("*").alias("n")))


def strings_customer(t, F):
    """Per-row unique strings: every row's bytes are checked."""
    return t["customer"].select(
        "c_custkey",
        F.substring_index("c_phone", "-", 1).alias("country"),
        F.replace("c_phone", "-", "").alias("digits"),
        F.concat(F.lower(F.substring_index("c_name", "#", 1)),
                 F.substring_index("c_name", "#", -1)).alias("handle"),
        F.ltrim(F.regexp_replace("c_name", "Customer#", " ")).alias("num"))


def strings_part(t, F):
    """The last word of p_type, title case, a rewritten colour and a padded
    brand, grouped."""
    return (t["part"].select(
        F.substring_index("p_type", " ", -1).alias("metal"),
        F.initcap("p_type").alias("title"),
        F.regexp_replace("p_name", "green", "GREEN").alias("name"),
        F.rtrim(F.concat("p_brand", F.lit("   "))).alias("brand"),
        "p_size")
        .groupBy("metal", "title", "name", "brand")
        .agg(F.count("*").alias("n"), F.sum("p_size").alias("size")))


STRING_PROGRAMS = {"strings_lineitem": strings_lineitem,
                   "strings_orders": strings_orders,
                   "strings_customer": strings_customer,
                   "strings_part": strings_part}
STRING_CONF = {"rapids.tpu.sql.incompatibleOps.enabled": True}
# the key columns each program's rows are sorted by before a comparison
STRING_KEYS = {"strings_lineitem": 4, "strings_orders": 3,
               "strings_customer": 1, "strings_part": 4}


STRING_WARM_REPS = 1
# phase 3's inputs: NULL, empty and all-space rows, non-ASCII and NUL
# bytes, delimiters at a row's first and last byte
TRANSFORM_ROWS = [
    b"", None, b"a", b" ", b"   ", b" a b ", b"Hello World", b"hELLO wORLD",
    "héllo wörld".encode(), b"\x00", b"a\x00b", b" \x00 ", b"\xff\xfe",
    b"#a#b#", b"#", b"##", b"a#", b"#a", b"abab", b"ab", b"COD",
    b"COLLECT COD", b"DELIVER IN PERSON", b"4-NOT SPECIFIED", b"x-y-z-",
    b"-", "日本 語".encode(), b"\x80abc", None, b"  REG AIR ", b"a b  c"]
TRANSFORM_DELIMS = (b"#", b"-", b" ", b"ab", "é".encode(), b"")
TRANSFORM_REPLACE = ((b"a", b"xyz"), (b"ab", b"Q"), (b"ab", b"ba"),
                     (b"#", b""), (b"COD", b"CASH ON DELIVERY"),
                     (b"\x00", b"0"))


def transform_column(rows, dev, cap=None, pad: int = 8):
    """(offsets, bytes, validity) on the card of raw byte rows (None is
    NULL) in `cap` lanes (lanes past the rows empty and NULL), the buffer
    `pad` bytes longer than the rows (0: exactly full)."""
    import numpy as np
    import torch

    cap = len(rows) if cap is None else cap
    lens = [len(r) if r is not None else 0 for r in rows]
    offsets = np.zeros(cap + 1, np.int32)
    offsets[1:len(rows) + 1] = np.cumsum(lens)
    offsets[len(rows) + 1:] = offsets[len(rows)]
    raw = b"".join(r for r in rows if r is not None) + bytes(pad)
    valid = np.zeros(cap, bool)
    valid[:len(rows)] = [r is not None for r in rows]
    return (torch.from_numpy(offsets).to(dev),
            torch.from_numpy(np.frombuffer(raw, np.uint8).copy()).to(dev),
            torch.from_numpy(valid).to(dev))


def one_row_source(value, dev):
    """K40's source of a literal: one row every lane reads (None: NULL)."""
    import torch

    raw = b"" if value is None else value
    return (torch.tensor([0, len(raw)], dtype=torch.int32, device=dev),
            torch.tensor(list(raw + bytes(8)), dtype=torch.uint8,
                         device=dev),
            torch.tensor([value is not None], device=dev), False)


def same_strings(got, want, label: str, errs: dict, name: str) -> None:
    """(offsets, bytes[, validity]) of a kernel and its plain version: the
    offsets and validity, and the bytes below the total, bit for bit."""
    check(bits_equal(got[0], want[0]), f"{label}: offsets differ")
    total = int(want[0][-1])
    check(bits_equal(got[1][:total], want[1][:total]),
          f"{label}: bytes differ")
    if len(got) > 2:
        check(bits_equal(got[2], want[2]), f"{label}: validity differs")
    errs[name] = max(errs.get(name, 0.0), max_abs_err(
        got[1][:total], want[1][:total]))


def compare_transforms(col, label: str, errs: dict, dev) -> None:
    """K37-K40 against their plain versions on one column, bit for bit."""
    from spark_rapids_tpu_torch.columnar import strings as S

    offsets, data, valid = col
    cap = int(valid.shape[0])
    for mode in ("upper", "lower", "initcap"):
        got = S.case_map(offsets, data, mode)
        want = S.case_map_plain(offsets, data, mode)
        check(bits_equal(got, want), f"K37 {mode} {label} differs")
        errs["string_case_map"] = max(errs.get("string_case_map", 0.0),
                                      max_abs_err(got, want))
    plans = [(side, b"", 0) for side in ("both", "left", "right")] + [
        ("index", d, k) for d in TRANSFORM_DELIMS for k in range(-3, 4)]
    for mode, delim, count in plans:
        got = S.span_plan(offsets, data, valid, mode, delim, count)
        want = S.span_plan_plain(offsets, data, valid, mode, delim, count)
        check(bits_equal(got[0], want[0]) and bits_equal(got[1], want[1]),
              f"K38 {mode} {delim!r} {count} {label} differs")
        errs["string_span_plan"] = max(errs.get("string_span_plan", 0.0),
                                       max_abs_err(got[0], want[0]))
    for find, repl in TRANSFORM_REPLACE:
        same_strings(S.string_replace(offsets, data, valid, find, repl),
                     S.replace_plain(offsets, data, valid, find, repl),
                     f"K39 {find!r} -> {repl!r} {label}", errs,
                     "string_replace")
    column = (offsets, data, valid, True)
    flipped = (offsets, data, valid.flip(0).contiguous(), True)
    members = [column, one_row_source(b"lit", dev), flipped,
               one_row_source(None, dev), column]
    for j in range(1, 6):
        srcs = members[:j]
        bound = sum(int(s[1].shape[0]) if s[3] else cap * int(s[0][1])
                    for s in srcs) + 8
        for sep in (None, b"", b", "):
            byte_cap = bound + (len(sep or b"") * cap * (j - 1))
            same_strings(S.string_concat(srcs, cap, sep, byte_cap),
                         S.concat_plain(srcs, cap, sep, byte_cap),
                         f"K40 J={j} sep {sep!r} {label}", errs,
                         "string_concat")


def string_transform_edge_cases(dev, errs: dict) -> int:
    """K37-K40 against their plain versions on the card, bit for bit:
    the edge rows (in 40 lanes), 20,000 random rows, a 1 MiB row, a 0-row
    batch (8 NULL lanes) and a buffer exactly full with empty lanes after
    the rows; every case map, trim, substring_index with each delimiter
    ('' too) and counts -3..3, a replacement that grows, shrinks, keeps
    the length and is empty, and concat / concat_ws of 1-5 members with
    literal and NULL-literal members."""
    import numpy as np

    rng = np.random.default_rng(43)
    alphabet = [b"a", b"b", b"A", b" ", b"#", b"-", b"COD", "é".encode(),
                b"\x00", b"ab"]
    many = [None if rng.random() < 0.1 else b"".join(
        alphabet[int(i)] for i in rng.integers(0, len(alphabet),
                                               int(rng.integers(0, 14))))
        for _ in range(20_000)]
    cases = [("edge rows", transform_column(TRANSFORM_ROWS, dev, cap=40)),
             ("random rows", transform_column(many, dev)),
             ("1 MiB row", transform_column(
                 [b"ab #-" * 209_715 + b"x#y", b"", b"COD"], dev, cap=8)),
             ("0 rows", transform_column([], dev, cap=8)),
             ("exactly full", transform_column([b"ab", b"xy", b""], dev,
                                               cap=8, pad=0))]
    for label, col in cases:
        compare_transforms(col, label, errs, dev)
    return len(cases)


def time_string_transform_kernels(dev, errs: dict, raw) -> dict:
    """K37-K40 at the path's shapes: one 15M-row lineitem partition's
    l_shipmode (K37 lower), l_shipinstruct (K38 substring_index ' ', -1;
    K39 'COD' -> 'CASH ON DELIVERY') and the concat_ws of l_returnflag,
    l_linestatus and l_shipmode (K40), each against its plain version bit
    for bit. Bounds count what this data needs: the bytes read once (K38's
    backward scan reads a row from its end to its last delimiter) and the
    outputs written once."""
    from spark_rapids_tpu_torch.columnar import strings as S
    from spark_rapids_tpu_torch.columnar.batch import HostColumnarBatch

    names = [a.name for a in raw["lineitem"].schema]
    part = raw["lineitem"]._plan.partitions[0]
    check(len(part) == 1, "lineitem's first partition is one batch")
    want = ("l_returnflag", "l_linestatus", "l_shipmode", "l_shipinstruct")
    batch = HostColumnarBatch([part[0].columns[names.index(c)]
                               for c in want]).to_device(dev)
    cols = dict(zip(want, batch.columns))
    n = part[0].num_rows
    cap = batch.capacity  # the lanes each kernel runs over
    iters, plain_iters = 10, 2
    rows = {}

    mode = cols["l_shipmode"]
    got = S.case_map(mode.offsets, mode.data, "lower")
    check(bits_equal(got, S.case_map_plain(mode.offsets, mode.data,
                                           "lower")), "K37 lower differs")
    total = int(mode.offsets[n])
    rows["string_case_map"] = dict(
        ms=cuda_ms(lambda: S.case_map(mode.offsets, mode.data, "lower"),
                   iters),
        plain_ms=cuda_ms(lambda: S.case_map_plain(mode.offsets, mode.data,
                                                  "lower"), plain_iters),
        library_ms=None,
        bound_ms=bound_ms(total + int(mode.data.shape[0]) + 8),
        shape=f"l_shipmode lower, {n} rows, {total} bytes")

    ins = cols["l_shipinstruct"]
    args = (ins.offsets, ins.data, ins.validity, "index", b" ", -1)
    spans, span_valid = S.span_plan(*args)
    w_spans, w_valid = S.span_plan_plain(*args)
    check(bits_equal(spans, w_spans) and bits_equal(span_valid, w_valid),
          "K38 substring_index differs")
    starts = ins.offsets[:-1].long()
    a = w_spans[0:2 * cap:2].long()
    ends = ins.offsets[1:].long()
    read = int(((ends - a) + (a > starts).long()).sum())
    rows["string_span_plan"] = dict(
        ms=cuda_ms(lambda: S.span_plan(*args), iters),
        plain_ms=cuda_ms(lambda: S.span_plan_plain(*args), plain_iters),
        library_ms=None,
        bound_ms=bound_ms(4 * (cap + 1) + read + cap + 4 * (2 * cap + 1) +
                          2 * cap),
        shape=f"l_shipinstruct substring_index(' ', -1), {n} rows")

    rep = (ins.offsets, ins.data, ins.validity, b"COD", b"CASH ON DELIVERY")
    got = S.string_replace(*rep)
    same_strings(got, S.replace_plain(*rep), "K39 path shape", errs,
                 "string_replace")
    out_total = int(got[0][-1])
    in_total = int(ins.offsets[n])
    rows["string_replace"] = dict(
        ms=cuda_ms(lambda: S.string_replace(*rep), iters),
        plain_ms=cuda_ms(lambda: S.replace_plain(*rep), plain_iters),
        library_ms=None,
        bound_ms=bound_ms(in_total + 4 * (cap + 1) + cap + out_total +
                          4 * (cap + 1)),
        shape=f"l_shipinstruct 'COD' -> 'CASH ON DELIVERY', {n} rows, "
              f"{in_total} -> {out_total} bytes")

    srcs = [(c.offsets, c.data, c.validity, True) for c in (
        cols["l_returnflag"], cols["l_linestatus"], mode)]
    byte_cap = sum(int(c[1].shape[0]) for c in srcs) + cap * 2
    got = S.string_concat(srcs, cap, b"|", byte_cap)
    same_strings(got, S.concat_plain(srcs, cap, b"|", byte_cap),
                 "K40 path shape", errs, "string_concat")
    in_bytes = sum(int(c[0][cap]) + 4 * (cap + 1) + cap for c in srcs)
    rows["string_concat"] = dict(
        ms=cuda_ms(lambda: S.string_concat(srcs, cap, b"|", byte_cap),
                   iters),
        plain_ms=cuda_ms(lambda: S.concat_plain(srcs, cap, b"|", byte_cap),
                         plain_iters),
        library_ms=None,
        bound_ms=bound_ms(in_bytes + int(got[0][cap]) + 4 * (cap + 1) +
                          cap),
        shape=f"concat_ws('|', l_returnflag, l_linestatus, l_shipmode), "
              f"{n} rows")
    del batch, cols, got
    return rows


def fixed_width_bytes(df, name: str, width: int):
    """The UTF-8 bytes of a STRING column whose every row is `width` bytes
    long, as a [rows, width] uint8 matrix (all partitions), or None."""
    import numpy as np

    col = [a.name for a in df.schema].index(name)
    mats = []
    for part in df._plan.partitions:
        for b in part:
            offs, raw = b.columns[col].utf8()
            if not (np.diff(offs) == width).all():
                return None
            mats.append(raw[:width * b.num_rows].reshape(-1, width))
    return np.concatenate(mats)


def customer_strings_rows(cust) -> list:
    """strings_customer's rows, the texts Python's string methods give:
    c_phone 'CC-DDD-DDD-DDDD' and c_name 'Customer#' + 9 digits (the
    generator's fixed layouts, checked) as byte matrices, column at a
    time."""
    import numpy as np

    keys = table_columns(cust, ("c_custkey",))["c_custkey"].tolist()
    phone = fixed_width_bytes(cust, "c_phone", 15)
    name = fixed_width_bytes(cust, "c_name", 18)
    check(phone is not None and name is not None and
          bool((phone[:, [2, 6, 10]] == ord("-")).all()) and
          not (phone[:, [0, 1]] == ord("-")).any() and
          bool((name[:, :9] == np.frombuffer(b"Customer#",
                                              np.uint8)).all()) and
          not (name[:, 9:] == ord("#")).any(),
          "customer: c_phone / c_name outside the generator's layout")

    def text(m):
        m = np.ascontiguousarray(m)
        return m.view(f"S{m.shape[1]}").ravel().astype(str).tolist()

    digits = text(name[:, 9:])
    return list(zip(keys, text(phone[:, :2]), text(
        phone[:, [0, 1, 3, 4, 5, 7, 8, 9, 11, 12, 13, 14]]),
        ["customer" + d for d in digits], digits))


def numpy_strings_wants(raw, li: dict, pools: dict) -> dict:
    """The four programs' rows by numpy and Python string operations over
    the generated columns: pool columns by their pool indices (each group a
    bincount over the combined index), c_name and c_phone row by row."""
    import numpy as np

    from spark_rapids_tpu_torch.benchmarks import tpch

    def idx(table, name, pool):
        key = f"pool_{name}"
        if key not in pools:
            pools[key] = pool_index(raw[table], name, pool)
        return pools[key]

    def grouped(codes, dims, labels, sums, sum_kind):
        """One row a non-empty group: the labels of its codes, the sum
        and the count."""
        flat = np.ravel_multi_index(codes, dims)
        size = int(np.prod(dims))
        n = np.bincount(flat, minlength=size)
        total = np.bincount(flat, weights=sums, minlength=size)
        hit = np.nonzero(n)[0]
        sums_out = total[hit].tolist() if sum_kind is float else \
            np.rint(total[hit]).astype(np.int64).tolist()
        return [(*labels(*parts), s, c) for parts, s, c in zip(
            zip(*(a.tolist() for a in np.unravel_index(hit, dims))),
            sums_out, n[hit].tolist())]

    out = {}
    # q1's one-byte keys are their UTF-8 bytes (phase 4's columns)
    flag = np.searchsorted(np.frombuffer("".join(tpch._FLAGS).encode(),
                                         np.uint8), li["l_returnflag"])
    status = np.searchsorted(np.frombuffer("".join(tpch._STATUS).encode(),
                                           np.uint8), li["l_linestatus"])
    mode = idx("lineitem", "l_shipmode", tpch._SHIPMODES)
    instr = idx("lineitem", "l_shipinstruct", tpch._INSTRUCT)

    def li_labels(f, s, m, i):
        ins = tpch._INSTRUCT[i]
        return ("|".join([tpch._FLAGS[f], tpch._STATUS[s],
                          tpch._SHIPMODES[m].lower()]),
                ins.replace("DELIVER IN PERSON", "HAND"),
                ins.replace("COD", "CASH ON DELIVERY"),
                ("  " + tpch._SHIPMODES[m] + " ").strip(" "))

    rows = grouped((flag, status, mode, instr),
                   (len(tpch._FLAGS), len(tpch._STATUS),
                    len(tpch._SHIPMODES), len(tpch._INSTRUCT)),
                   li_labels, li["l_extendedprice"], float)
    out["strings_lineitem"] = rows
    o = table_columns(raw["orders"], ("o_totalprice",))
    prio = idx("orders", "o_orderpriority", tpch._PRIORITIES)
    ostat = idx("orders", "o_orderstatus", ["F", "O", "P"])

    def o_labels(p, st):
        code, name = tpch._PRIORITIES[p].split("-", 1)
        return (" ".join(w[:1].upper() + w[1:] for w in
                         name.lower().split(" ")), code, "FOP"[st])

    out["strings_orders"] = grouped((prio, ostat), (len(tpch._PRIORITIES),
                                                    3), o_labels,
                                    o["o_totalprice"], float)
    out["strings_customer"] = customer_strings_rows(raw["customer"])
    p = table_columns(raw["part"], ("p_size", "p_name", "p_brand"))

    def numbered(values):
        """(codes, distinct values): names and brands share their first
        five bytes, so a dictionary, not pool_index, numbers them."""
        seen = {}
        codes = np.fromiter((seen.setdefault(v, len(seen)) for v in values),
                            np.int64, len(values))
        return codes, list(seen)

    pname, names = numbered(p.pop("p_name"))
    pbrand, brands = numbered(p.pop("p_brand"))
    ptype = idx("part", "p_type", tpch._TYPES)

    type_labels = [(ty.split(" ")[-1], " ".join(w[:1] + w[1:].lower()
                                                for w in ty.split(" ")))
                   for ty in tpch._TYPES]
    name_labels = [nm.replace("green", "GREEN") for nm in names]

    def p_labels(t, nm, b):
        return (*type_labels[t], name_labels[nm], brands[b])

    rows = grouped((ptype, pname, pbrand), (len(tpch._TYPES), len(names),
                                            len(brands)), p_labels,
                   p["p_size"].astype(np.float64), int)
    out["strings_part"] = [r[:4] + (r[5], r[4]) for r in rows]
    for name, k in STRING_KEYS.items():
        out[name].sort(key=lambda r: r[:k])
    return out


def run_strings(sess, raw, tables, li: dict, wants: dict, launches: dict,
                dev, errs: dict) -> dict:
    """Phase 15 (after phase 6, over phase 4's cached SF 10 tables): the
    four string-cleaning programs with incompatibleOps on, one cold and
    STRING_WARM_REPS warm runs each, every operator on the card, rows
    (sorted) against numpy; K37-K40 timed at the path's shapes
    ("kernel_rows")."""
    from spark_rapids_tpu_torch import cuda_build as CB
    from spark_rapids_tpu_torch.plan import functions as F

    t = time.perf_counter()
    want = numpy_strings_wants(raw, li, wants.setdefault("pools", {}))
    out = {"numpy_s": time.perf_counter() - t}
    log(f"phase 15: numpy references ready in {out['numpy_s']:.1f} s")
    table_rows = {k: sum(b.num_rows for part in v._plan.partitions
                         for b in part) for k, v in raw.items()}
    for k, v in STRING_CONF.items():
        sess.set_conf(k, v)
    try:
        for name, fn in STRING_PROGRAMS.items():
            CB.reset_launch_counts()
            k = STRING_KEYS[name]
            res = run_query(sess, fn(tables, F), want[name], name,
                            STRING_WARM_REPS, order=lambda r: r[:k])
            launches[name] = CB.launch_counts()
            rows_in = table_rows[name.split("_")[1]]
            res.update(input_rows=rows_in, rows_per_s=rows_in / best_s(res),
                       checked_against="numpy (sorted rows)")
            out[name] = res
    finally:
        for k in STRING_CONF:
            sess.set_conf(k, False)
    out["kernel_rows"] = time_string_transform_kernels(dev, errs, raw)
    out["phase_s"] = time.perf_counter() - t
    log(f"phase 15: {out['phase_s']:.1f} s")
    return out


# ------------------------------------------------ phase 16 (slice 14)
# Casts to and from STRING over phase 4's cached tables: F is either
# package's functions module, so the CPU tests run the same text on both.
def casts_lineitem(t, F):
    """Dates and prices formatted, a timestamp built from the text and
    formatted back, every price parsed back, grouped by the texts."""
    day = F.col("l_shipdate").cast("string")
    px = F.col("l_extendedprice").cast("string")
    stamp = F.concat(day, F.lit(" 08:30:00.250")).cast("timestamp")
    return (t["lineitem"].select(
        day.alias("day"), stamp.cast("string").alias("stamp"),
        (px.cast("double") == F.col("l_extendedprice")).cast("int")
        .alias("same"), "l_extendedprice")
        .groupBy("day", "stamp")
        .agg(F.count("*").alias("n"), F.sum("same").alias("same"),
             F.sum("l_extendedprice").alias("price")))


def casts_orders(t, F):
    """A local time with a zone read as UTC (the next day), the key's
    leading digit, every price parsed back, grouped."""
    local = F.concat(F.col("o_orderdate").cast("string"),
                     F.lit("T23:59:59.999999-02:00")).cast("timestamp")
    px = F.col("o_totalprice").cast("string")
    return (t["orders"].select(
        local.cast("date").cast("string").alias("utc_day"),
        F.substring(F.col("o_orderkey").cast("string"), 1, 1).alias("lead"),
        (px.cast("double") == F.col("o_totalprice")).cast("int")
        .alias("same"), "o_totalprice")
        .groupBy("utc_day", "lead")
        .agg(F.count("*"), F.sum("same"), F.sum("o_totalprice")))


def casts_customer(t, F):
    """Every row's texts: the key, the balance as DOUBLE and FLOAT, a
    boolean, the phone digits as a DOUBLE (scientific), and the balance
    parsed back through leading whitespace."""
    return t["customer"].select(
        "c_custkey",
        F.col("c_custkey").cast("string").alias("key"),
        F.col("c_acctbal").cast("string").alias("bal"),
        F.col("c_acctbal").cast("float").cast("string").alias("bal32"),
        (F.col("c_acctbal") > F.lit(0.0)).cast("string").alias("pos"),
        F.replace("c_phone", "-", "").cast("double").cast("string")
        .alias("num"),
        F.concat(F.lit(" \t"), F.col("c_acctbal").cast("string"))
        .cast("double").alias("back"))


CAST_PROGRAMS = {"casts_lineitem": casts_lineitem,
                 "casts_orders": casts_orders,
                 "casts_customer": casts_customer}
CAST_CONF = {"rapids.tpu.sql.castFloatToString.enabled": True,
             "rapids.tpu.sql.castStringToFloat.enabled": True,
             "rapids.tpu.sql.castStringToTimestamp.enabled": True}
# the key columns each program's rows are sorted by before a comparison
CAST_KEYS = {"casts_lineitem": 2, "casts_orders": 2, "casts_customer": 1}
CAST_WARM_REPS = 1
CAST_FUZZ_ROWS = 1 << 20  # phase 3's random rows a set
FP64_OPS_PER_S = 34e12  # H100 SXM FP64 outside the tensor cores (data sheet)


def java_text(r: str) -> str:
    """Java's Double.toString placement of the digits and exponent that
    Python's repr of a double (or numpy's str of a float32) gives: plain
    for -3 <= e10 < 7, else d.dddE[-]ee, '.0' after an integral value."""
    sign = "-" if r.startswith("-") else ""
    mant, _, exp = r.lstrip("-").partition("e")
    ip, _, fp = mant.partition(".")
    digits = (ip + fp).lstrip("0")
    if not digits.strip("0"):
        return sign + "0.0"
    e10 = int(exp or 0) + len(ip) - 1 - (len(ip + fp) - len(digits))
    digits = digits.rstrip("0")
    p = len(digits)
    if not -3 <= e10 < 7:
        return f"{sign}{digits[0]}.{digits[1:] or '0'}E{e10}"
    if e10 >= p - 1:
        return sign + digits + "0" * (e10 - p + 1) + ".0"
    if e10 >= 0:
        return sign + digits[:e10 + 1] + "." + digits[e10 + 1:]
    return sign + "0." + "0" * (-e10 - 1) + digits


def iso_days(days) -> list:
    """ISO dates of epoch days by Python's datetime."""
    import datetime

    epoch = datetime.date(1970, 1, 1)
    return [(epoch + datetime.timedelta(days=int(d))).isoformat()
            for d in days]


def numpy_casts_wants(raw, li: dict) -> dict:
    """casts_lineitem's and casts_orders' rows by numpy over the generated
    columns and Python's datetime: a group a date (and a leading digit,
    found by comparisons with powers of ten) by bincount, every price
    parsed back."""
    import numpy as np

    def grouped(code, weights):
        lo = int(code.min())
        n = np.bincount(code - lo)
        total = np.bincount(code - lo, weights=weights)
        at = np.nonzero(n)[0]
        return at + lo, n[at], total[at]

    out = {}
    days, n, price = grouped(li["l_shipdate"].astype(np.int64),
                             li["l_extendedprice"])
    out["casts_lineitem"] = [
        (d, d + " 08:30:00.25", int(c), int(c), float(s))
        for d, c, s in zip(iso_days(days), n, price)]
    o = table_columns(raw["orders"], ("o_orderdate", "o_orderkey",
                                      "o_totalprice"))
    key = o["o_orderkey"]
    nd = np.ones(len(key), np.int64)
    for j in range(1, 19):
        nd += key >= 10 ** j
    lead = key // np.array([10 ** j for j in range(19)])[nd - 1]
    check(bool((lead >= 0).all() and (lead <= 9).all()),
          "o_orderkey's leading digits")
    groups, n, price = grouped(
        (o["o_orderdate"].astype(np.int64) + 1) * 10 + lead,
        o["o_totalprice"])
    out["casts_orders"] = [
        (d, str(int(g % 10)), int(c), int(c), float(s))
        for d, g, c, s in zip(iso_days(groups // 10), groups, n, price)]
    for name in out:
        out[name].sort(key=lambda r: r[:CAST_KEYS[name]])
    return out


def _java_nums(phones) -> list:
    """java_text of each phone's digits read as a double. Twelve digits
    without a leading zero are an exact double of exponent 11, whose text
    is the digits with the trailing zeros dropped (java_text's own rule,
    without the repr round trip); any other phone goes through java_text."""
    out = []
    for ph in phones:
        d = ph.replace("-", "")
        if len(d) == 12 and d.isdigit() and d[0] != "0":
            out.append(f"{d[0]}.{d[1:].rstrip('0') or '0'}E11")
        else:
            out.append(java_text(repr(float(d))))
    return out


def check_casts_customer(rows, c: dict) -> int:
    """casts_customer's rows (sorted by c_custkey) against Python, column
    by column: str of the key, java_text of repr(c_acctbal) and of numpy's
    str of its float32, 'true' / 'false', java_text of the phone digits'
    double, the balance parsed back exactly. Where 1e-3 <= |x| < 1e7 (or
    x is 0) repr's plain text is already Java's, so java_text is skipped
    there. Returns the rows checked."""
    import numpy as np

    order = np.argsort(c["c_custkey"], kind="stable")
    keys = c["c_custkey"][order].tolist()
    check(len(rows) == len(keys), "casts_customer: row count")

    def texts(x, reprs):
        a = np.abs(x)
        plain = ((a >= 1e-3) & (a < 1e7)) | (a == 0)
        return [r if ok else java_text(r)
                for r, ok in zip(reprs, plain.tolist())]

    bal = c["c_acctbal"][order]
    b32 = bal.astype(np.float32)
    want = {"c_custkey": keys, "key": list(map(str, keys)),
            "bal": texts(bal, map(repr, bal.tolist())),
            "bal32": texts(b32, b32.astype(str).tolist()),
            "pos": np.where(bal > 0.0, "true", "false").tolist(),
            "num": _java_nums(c["c_phone"][order]),
            "back": bal.tolist()}
    for (name, w), g in zip(want.items(), zip(*rows)):
        g = list(g)
        if g != w:
            i = next(k for k, (a, b) in enumerate(zip(g, w)) if a != b)
            raise SmokeFailure(f"casts_customer {name} row {i}: {g[i]!r} "
                               f"!= {w[i]!r}")
    return len(rows)


def same_values(got, want) -> bool:
    """Parsed values: NaN where the other is NaN, bit for bit elsewhere
    (so -0.0 differs from 0.0)."""
    import torch

    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    if got.dtype.is_floating_point:
        nan = torch.isnan(want)
        if not torch.equal(torch.isnan(got), nan):
            return False
        return bits_equal(torch.where(nan, 0.0, got).to(got.dtype),
                          torch.where(nan, 0.0, want).to(want.dtype))
    return bits_equal(got, want)


def compare_k41(x, valid, mode: str, label: str, errs: dict) -> None:
    from spark_rapids_tpu_torch.columnar import format as FMT

    plain = {"int": FMT.int_to_string_plain, "bool": FMT.bool_to_string_plain,
             "date": FMT.date_to_string_plain,
             "timestamp": FMT.timestamp_to_string_plain}[mode]
    same_strings(FMT.format_fixed(x, valid, mode), plain(x, valid),
                 f"K41 {mode} {label}", errs, "format_fixed")


def compare_k42(x, valid, label: str, errs: dict):
    """K42 against its plain version; returns the text (offsets, bytes)."""
    from spark_rapids_tpu_torch.columnar import format as FMT

    got = FMT.format_float(x, valid)
    same_strings(got, FMT.float_to_string_plain(x, valid), f"K42 {label}",
                 errs, "format_float")
    return got


def compare_parse(kernel: str, col, label: str, errs: dict,
                  to32: bool = False) -> None:
    """K43 (f64 and, with to32, f32) or K44 against its plain version:
    value, validity and malformed flags."""
    import torch

    from spark_rapids_tpu_torch.columnar import parse as PRS

    offsets, data, valid = col
    if kernel == "parse_float":
        got = PRS.parse_float(offsets, data, valid, to32)
        want = PRS.parse_float_plain(offsets, data, valid, to32)
    else:
        got = PRS.parse_timestamp(offsets, data, valid)
        want = PRS.parse_timestamp_plain(offsets, data, valid)
    check(same_values(got[0], want[0]), f"{kernel} {label}: values differ")
    check(bits_equal(got[1], want[1]), f"{kernel} {label}: validity differs")
    check(bits_equal(got[2], want[2]),
          f"{kernel} {label}: malformed flags differ")
    keep = want[1] & (torch.isfinite(want[0]) if want[0].is_floating_point()
                      else True)
    errs[kernel] = max(errs.get(kernel, 0.0), max_abs_err(got[0][keep],
                                                          want[0][keep]))


FLOAT_TEXT_ROWS = [
    b"", b" ", b"+", b"-", b".", b"1.", b".5", b"1e", b"1e+", b"1e400",
    b"1e-400", b"1e1000", b"1" * 48, b"1" * 49, b"0." + b"1" * 46,
    b"inf", b"-Infinity", b"NaN ", b"iNf", b"+nan", b"-nAn", b"infinit",
    b"\t1.5\n", b"1,5", b"0x10", b"12345678901234567",
    b"123456789012345678", b"1234567890123456789012345",
    b"0.000000000000000000001234567890123456789", b"000000000000012.5",
    b"-0", b"-0.0", b"+.5e-3", b"5.E2", b"1e+308", b"1.7976931348623157e308",
    b"1.7976931348623159e308", b"4.9e-324", b"2.2250738585072014E-308",
    b"3.4028235e38", b"3.4028236e38", b"1.4e-45", b"1.17549435E-38",
    b"1e2e3", b"1-2", b"--1", b"1.2.3", b"1e3.5", b"e5", b"1 2",
    "１２".encode(), "é1".encode(), b"1\x00", b"\x001", b"\xff",
    b"  -12.75e-1  ", b"9" * 30, b"0" * 60, b"1e-5", None]
TS_TEXT_ROWS = [
    b"2023-02-30", b"2024-02-29", b"2023-02-29", b"2020-01-01 24:00:00",
    b"2020-01-01 23:59:59", b"2020-01-01T12:34:56Z",
    b"2020-01-01 12:34:56+05:30", b"2020-01-01 12:34:56-02:00",
    b"2020-01-01 12:34:56.1234567", b"2020-01-01 12:34:56.123456",
    b"2020-01-01 12:34:56.", b"2020-01-01 12:34:56.5Z",
    b"2020-01-01 12:34:56.123456+05:30",      # 32 characters
    b"2020-01-01 12:34:56.123456+05:300",     # 33
    b"2020-01-01 12:34:56.123456+05:3000",    # 34
    b"2020-01-01 12:34:56.12345+05:30",       # 31
    b"0000-01-01", b"9999-12-31 23:59:59.999999", b"  2020-06-15  ",
    b"\t2020-06-15 01:02:03\n", b"2020-06-15 01:02", b"2020-6-15",
    b"2020-06-15 01:02:03+24:00", b"2020-06-15 01:02:03+05:60",
    b"2020-06-15 01:02:03+0530", b"2020-06-15X01:02:03", b"", b" ",
    b"1969-12-31 23:59:59.999999", b"2020-13-01", b"2020-00-10",
    "２０２０-01-01".encode(), b"2020-01-01\x00", None]


def _int_edges(np_dtype):
    import numpy as np

    info = np.iinfo(np_dtype)
    vals = [int(info.min), int(info.max), 0, 1, -1, int(info.min) + 1,
            int(info.max) - 1]
    for k in range(1, 19):
        for v in (10 ** k - 1, 10 ** k, 10 ** k + 1):
            for s in (v, -v):
                if info.min <= s <= info.max:
                    vals.append(s)
    return np.array(vals, dtype=np_dtype)


def cast_edge_cases(dev, errs: dict) -> int:
    """K41-K44 against their plain versions on the card, bit for bit (NaN
    by isnan): int8-int64 ends and 10^k +- 1, booleans, dates at both ends
    of int32 days, years -1, 0, 9999 and 10000, leap days, timestamps at
    both ends of int64 and fractions .1, .000001, .123456, .5 before and
    after 1970; +-0.0, NaN, +-Inf, the subnormal and normal ends, every
    power of two, 1M random f64 and 1M random f32 bit patterns; the float
    grammar's edge rows (48 and 49 characters, words, whitespace, 17, 18
    and 25 digits, non-ASCII and NUL) and K42's text of the random sets
    parsed back; the timestamp grammar's rows (31-34 characters, zones,
    7 fraction digits) and K41's text of 1M random timestamps parsed
    back; NULL rows, an all-NULL batch, a 0-row batch in each."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.columnar import format as FMT
    from spark_rapids_tpu_torch.columnar import parse as PRS
    from spark_rapids_tpu_torch.ops.cast import _days_from_civil

    rng = np.random.default_rng(47)
    sets = 0

    def put(values, null_every=0, cap=None):
        x = torch.as_tensor(values).to(dev)
        n = int(x.shape[0])
        cap = n if cap is None else cap
        if cap > n:
            x = torch.cat([x, torch.zeros(cap - n, dtype=x.dtype,
                                          device=dev)])
        valid = torch.arange(cap, device=dev) < n
        if null_every:
            valid &= torch.arange(cap, device=dev) % null_every != 3
        return x, valid

    many = CAST_FUZZ_ROWS
    for dt in (np.int8, np.int16, np.int32, np.int64):
        edges = _int_edges(dt)
        info = np.iinfo(dt)
        rand = rng.integers(info.min, info.max, many, dtype=dt,
                            endpoint=True)
        for label, vals, nulls, cap in (
                ("edges", edges, 0, len(edges) + 5),
                ("edges with NULLs", edges, 4, None),
                ("1M random", rand, 17, None)):
            compare_k41(*put(vals, nulls, cap), "int", f"{dt.__name__} "
                        f"{label}", errs)
            sets += 1
    compare_k41(*put(rng.integers(0, 2, 1000).astype(bool), 5), "bool",
                "random", errs)
    date_edges = [np.iinfo(np.int32).min, np.iinfo(np.int32).max, 0, -1]
    for y in (-1, 0, 1, 1900, 1969, 1970, 2000, 2024, 9999, 10000, -10000):
        date_edges += [_days_from_civil(y, 1, 1),
                       _days_from_civil(y, 12, 31)]
    for y, m, d in ((2000, 2, 29), (2024, 2, 29), (1900, 2, 28),
                    (1900, 3, 1), (1600, 2, 29), (-4, 2, 29)):
        date_edges.append(_days_from_civil(y, m, d))
    dates = np.array(date_edges, np.int32)
    rand_days = rng.integers(np.iinfo(np.int32).min, np.iinfo(np.int32).max,
                             many, dtype=np.int32)
    for label, vals, nulls in (("edges", dates, 0), ("edges with NULLs",
                                                     dates, 4),
                               ("1M random", rand_days, 13)):
        compare_k41(*put(vals, nulls), "date", label, errs)
        sets += 1
    i64 = np.iinfo(np.int64)
    day = 86_400_000_000
    ts_edges = [i64.min, i64.max, 0, 1, -1, 100_000, 1, 123_456, 500_000,
                -1_500_000, -86_399_999_999, -day, day - 1,
                -day * 719_528 + 100_000, 253_402_300_799_999_999,
                253_402_300_800_000_000, -62_167_219_200_000_000 - 1,
                i64.min + 1, i64.max - 1, -123_456, -500_000]
    in_range = rng.integers(-62_135_596_800_000_000, 253_402_300_799_999_999,
                            many, dtype=np.int64)
    in_range[::3] -= in_range[::3] % 1_000_000  # whole seconds
    for label, vals, nulls in (
            ("edges", np.array(ts_edges, np.int64), 0),
            ("1M random", rng.integers(i64.min, i64.max, many,
                                       dtype=np.int64), 11),
            ("1M years 1-9999", in_range, 0)):
        x, valid = put(vals, nulls)
        compare_k41(x, valid, "timestamp", label, errs)
        sets += 1
    text = FMT.format_fixed(x, valid, "timestamp")
    compare_parse("parse_timestamp", (text[0], text[1], valid),
                  "K41's text of 1M timestamps", errs)
    check(bits_equal(PRS.parse_timestamp(text[0], text[1], valid)[0], x),
          "K44 does not parse K41's timestamps back")
    sets += 1

    f64_edges = np.array(
        [0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf, 5e-324,
         2.2250738585072009e-308, 2.2250738585072014e-308,
         1.7976931348623157e308, -1.7976931348623157e308, 1e-3,
         9.999999e-4, 1e7, 9999999.0, 0.1, 1.5, 123456.789, 1e20, 1.23e-7,
         1e-4, 3.141592653589793, 2.0 ** 63, 1e16, 1e-100, 1e-300,
         5e-300, 9007199254740993.0] +
        list(np.ldexp(1.0, np.arange(-1074, 1024))), np.float64)
    f32_edges = np.concatenate([
        np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 3.4028235e38,
                  -3.4028235e38, 1.1754944e-38, 1.1754942e-38, 1e-45,
                  0.1, 7.0, 1e10, 16777217.0], np.float32),
        np.arange(1, 4097, dtype=np.uint32).view(np.float32),
        np.array([0x7FFFFF, 0x800001, 0x807FFFFF], np.uint32)
        .view(np.float32)])
    with np.errstate(invalid="ignore"):
        f64_rand = rng.integers(0, 2 ** 64, many, dtype=np.uint64,
                                endpoint=False).view(np.float64)
        f32_rand = rng.integers(0, 2 ** 32, many, dtype=np.uint64) \
            .astype(np.uint32).view(np.float32)
    for label, vals, nulls in (("f64 edges", f64_edges, 0),
                               ("f64 edges with NULLs", f64_edges, 7),
                               ("1M random f64 bits", f64_rand, 19),
                               ("f32 edges", f32_edges, 0),
                               ("1M random f32 bits", f32_rand, 23)):
        x, valid = put(vals, nulls)
        text = compare_k42(x, valid, label, errs)
        col = (text[0], text[1], valid)
        compare_parse("parse_float", col, f"K42's text of {label}", errs)
        compare_parse("parse_float", col, f"K42's text of {label} (f32)",
                      errs, to32=True)
        sets += 1
    for label, rows, cap in (("grammar rows", FLOAT_TEXT_ROWS, 80),):
        col = transform_column(rows, dev, cap=cap)
        compare_parse("parse_float", col, label, errs)
        compare_parse("parse_float", col, label + " (f32)", errs, to32=True)
        sets += 1
    compare_parse("parse_timestamp", transform_column(TS_TEXT_ROWS, dev,
                                                      cap=40),
                  "grammar rows", errs)
    empty = transform_column([], dev, cap=8)
    nulls = transform_column([None] * 9, dev, cap=16)
    for label, col in (("0 rows", empty), ("all NULL", nulls)):
        compare_parse("parse_float", col, label, errs)
        compare_parse("parse_timestamp", col, label, errs)
        for mode, dt in (("int", torch.int64), ("bool", torch.bool),
                         ("date", torch.int32),
                         ("timestamp", torch.int64)):
            compare_k41(torch.zeros(int(col[2].shape[0]), dtype=dt,
                                    device=dev), col[2], mode, label, errs)
        compare_k42(torch.zeros(int(col[2].shape[0]), dtype=torch.float64,
                                device=dev), col[2], label, errs)
        sets += 1
    return sets


def time_cast_kernels(dev, errs: dict, raw) -> dict:
    """K41-K44 at the path's shapes: one 15M-row lineitem partition's
    l_shipdate (K41 date), l_orderkey (K41 int), l_extendedprice (K42),
    K42's text (K43) and concat(day, ' 08:30:00.250') (K44), each against
    its plain version bit for bit. Bounds count this data: the inputs read
    once and the outputs written once; K42 also its FP64 operations from
    each row's (p, e10), the larger of the two."""
    import torch

    from spark_rapids_tpu_torch.columnar import format as FMT
    from spark_rapids_tpu_torch.columnar import parse as PRS
    from spark_rapids_tpu_torch.columnar import strings as S
    from spark_rapids_tpu_torch.columnar.batch import HostColumnarBatch

    names = [a.name for a in raw["lineitem"].schema]
    part = raw["lineitem"]._plan.partitions[0]
    check(len(part) == 1, "lineitem's first partition is one batch")
    want = ("l_shipdate", "l_orderkey", "l_extendedprice")
    batch = HostColumnarBatch([part[0].columns[names.index(c)]
                               for c in want]).to_device(dev)
    cols = dict(zip(want, batch.columns))
    n = part[0].num_rows
    cap = batch.capacity
    iters, plain_iters = 10, 1
    rows = {}

    def text_bytes(t):
        return int(t[0][-1]) + 4 * (cap + 1)

    for mode, col, what in (("date", cols["l_shipdate"], "l_shipdate"),
                            ("int", cols["l_orderkey"], "l_orderkey")):
        args = (col.data, col.validity, mode)
        got = FMT.format_fixed(*args)
        compare_k41(*args, f"path shape {what}", errs)
        rows[f"format_fixed_{mode}"] = dict(
            ms=cuda_ms(lambda: FMT.format_fixed(*args), iters),
            plain_ms=cuda_ms(lambda: {"date": FMT.date_to_string_plain,
                                      "int": FMT.int_to_string_plain}[mode](
                col.data, col.validity), plain_iters),
            library_ms=None,
            bound_ms=bound_ms(col.data.element_size() * cap + cap +
                              text_bytes(got)),
            shape=f"{what} {mode}, {n} rows in {cap} lanes, "
                  f"{int(got[0][-1])} bytes")
    price = cols["l_extendedprice"]
    text = FMT.format_float(price.data, price.validity)
    compare_k42(price.data, price.validity, "path shape", errs)
    m, p, e10, neg, kind = FMT.float_decompose(price.data)
    live = price.validity & (kind == 0)
    pe, ee = p[live], e10[live]
    ops = int((8 + 33 * pe + torch.where(
        ee > 0, 25 * ((ee + 21) // 22), 22 * ((-ee + 21) // 22))).sum())
    b_ms = bound_ms(9 * cap + text_bytes(text))
    o_ms = ops / FP64_OPS_PER_S * 1e3
    rows["format_float"] = dict(
        ms=cuda_ms(lambda: FMT.format_float(price.data, price.validity),
                   iters),
        plain_ms=cuda_ms(lambda: FMT.float_to_string_plain(
            price.data, price.validity), plain_iters),
        library_ms=None, bound_ms=max(b_ms, o_ms),
        bound_by="operations" if o_ms > b_ms else "bytes",
        bytes_bound_ms=b_ms, ops_bound_ms=o_ms, fp64_ops=ops,
        shape=f"l_extendedprice, {n} rows, {int(text[0][-1])} bytes, "
              f"p {float(pe.double().mean()):.3f} digits on average")
    col = (text[0], text[1], price.validity)
    compare_parse("parse_float", col, "path shape", errs)
    back = PRS.parse_float(*col)
    check(bits_equal(back[0][:n], price.data[:n]),
          "K43 does not parse K42's prices back")
    rows["parse_float"] = dict(
        ms=cuda_ms(lambda: PRS.parse_float(*col), iters),
        plain_ms=cuda_ms(lambda: PRS.parse_float_plain(*col), plain_iters),
        library_ms=None,
        bound_ms=bound_ms(text_bytes(text) + cap + 10 * cap),
        shape=f"K42's text of l_extendedprice, {n} rows")
    day = FMT.format_fixed(cols["l_shipdate"].data,
                           cols["l_shipdate"].validity, "date")
    srcs = [(day[0], day[1], cols["l_shipdate"].validity, True),
            one_row_source(b" 08:30:00.250", dev)]
    byte_cap = int(day[1].shape[0]) + 13 * cap + 8
    stamp = S.string_concat(srcs, cap, None, byte_cap)
    scol = (stamp[0], stamp[1], stamp[2])
    compare_parse("parse_timestamp", scol, "path shape", errs)
    rows["parse_timestamp"] = dict(
        ms=cuda_ms(lambda: PRS.parse_timestamp(*scol), iters),
        plain_ms=cuda_ms(lambda: PRS.parse_timestamp_plain(*scol),
                         plain_iters),
        library_ms=None,
        bound_ms=bound_ms(text_bytes(stamp) + cap + 10 * cap),
        shape=f"concat(day, ' 08:30:00.250'), {n} rows")
    rows["format_fixed"] = rows.pop("format_fixed_date")
    rows["format_fixed"].update({f"{k}_int": v for k, v in rows.pop(
        "format_fixed_int").items()})
    del batch, cols, text, day, stamp
    return rows


def run_casts(sess, raw, tables, li: dict, launches: dict, dev,
              errs: dict) -> dict:
    """Phase 16 (after phase 15, over phase 4's cached SF 10 tables): the
    three cast programs with the three cast keys on, one cold and
    CAST_WARM_REPS warm runs each, every operator on the card; lineitem's
    and orders' rows (sorted) against numpy, customer's every row against
    Python; K41-K44 timed at the path's shapes ("kernel_rows")."""
    from spark_rapids_tpu_torch import cuda_build as CB
    from spark_rapids_tpu_torch.plan import functions as F

    t = time.perf_counter()
    want = numpy_casts_wants(raw, li)
    out = {"numpy_s": time.perf_counter() - t}
    table_rows = {k: sum(b.num_rows for part in v._plan.partitions
                         for b in part) for k, v in raw.items()}
    for k, v in CAST_CONF.items():
        sess.set_conf(k, v)
    try:
        for name, fn in CAST_PROGRAMS.items():
            CB.reset_launch_counts()
            k = CAST_KEYS[name]
            res = run_query(sess, fn(tables, F), want.get(name), name,
                            CAST_WARM_REPS, order=lambda r: r[:k],
                            keep_rows=name not in want)
            launches[name] = CB.launch_counts()
            rows_in = table_rows[name.split("_")[1]]
            against = "numpy (sorted rows)"
            if name not in want:
                c = table_columns(raw["customer"], ("c_custkey", "c_acctbal",
                                                    "c_phone"))
                t1 = time.perf_counter()
                check_casts_customer(sorted(res.pop("result_rows"),
                                            key=lambda r: r[:k]), c)
                res["python_check_s"] = time.perf_counter() - t1
                against = "Python, every row"
            res.update(input_rows=rows_in, rows_per_s=rows_in / best_s(res),
                       checked_against=against)
            out[name] = res
    finally:
        for k in CAST_CONF:
            sess.set_conf(k, False)
    out["kernel_rows"] = time_cast_kernels(dev, errs, raw)
    out["phase_s"] = time.perf_counter() - t
    log(f"phase 16: {out['phase_s']:.1f} s")
    return out


# ------------------------------------------------ phase 17 (slice 15)
# the DataFrame surface over phase 4's cached tables: rollup / cube
# through Expand, repartition / coalesce, distinct / dropDuplicates,
# range, count / show, the GroupedData shortcuts
SURFACE_RANGE_ROWS = 1 << 27     # session.range's ids at TPCH_SF
SURFACE_RANGE_PARTITIONS = 8
SURFACE_RR = 64                  # lineitem.repartition(n)
SURFACE_HASH = 32                # orders.repartition(n, "o_custkey")
K45_ROWS = 1 << 25
K45_MANY = 5000


def surface_range_rows(sf: float) -> int:
    return max(1000, int(SURFACE_RANGE_ROWS * sf / TPCH_SF))


def surface_rollup(s, t, F, sf):
    """(a) lineitem's rollup: three grouping sets through Expand; min / max
    of two STRING columns (K47) and of two BOOL predicates (K3)."""
    return t["lineitem"].rollup("l_returnflag", "l_linestatus").agg(
        F.sum("l_quantity").alias("qty"),
        F.avg("l_extendedprice").alias("avg_price"),
        F.min("l_shipmode").alias("min_mode"),
        F.max("l_shipinstruct").alias("max_instruct"),
        F.max(F.col("l_discount") > 0.05).alias("any_disc"),
        F.min(F.col("l_tax") < 0.02).alias("all_low_tax"),
        F.count("*").alias("n"))


def surface_cube(s, t, F, sf):
    """(b) orders' cube: four grouping sets; max of a STRING (K47)."""
    return t["orders"].cube("o_orderstatus", "o_orderpriority").agg(
        F.count("*").alias("n"), F.sum("o_totalprice").alias("price"),
        F.max("o_comment").alias("max_comment"))


def surface_repartition(s, t, F, sf):
    """(c) round robin into SURFACE_RR partitions (K45, then K46 and K7 on
    the routed tier), a renamed and a dropped column, then grouped."""
    return (t["lineitem"].withColumnRenamed("l_returnflag", "flag")
            .drop("l_comment", "l_shipinstruct")
            .repartition(SURFACE_RR).groupBy("flag")
            .agg(F.count("*").alias("n"), F.sum("l_quantity").alias("qty")))


def surface_distinct(s, t, F, sf):
    """(d) a hash repartition on o_custkey, then distinct pairs."""
    return (t["orders"].repartition(SURFACE_HASH, "o_custkey")
            .select("o_custkey", "o_orderstatus").distinct())


def surface_dedup_pair(s, t, F, sf):
    """(e) dropDuplicates over (l_orderkey, l_partkey): nearly every row
    (the generated lineitem has no l_linenumber)."""
    return t["lineitem"].select("l_orderkey", "l_partkey", "l_quantity",
                                "l_extendedprice").dropDuplicates(
        ["l_orderkey", "l_partkey"])


def surface_dedup_key(s, t, F, sf):
    """(e) dropDuplicates over l_orderkey: one input row a key (First)."""
    return t["lineitem"].select("l_orderkey", "l_partkey", "l_quantity",
                                "l_extendedprice").dropDuplicates(
        ["l_orderkey"])


def surface_range(s, t, F, sf):
    """(f) session.range (a host exec, uploaded), round robin into 16
    partitions, grouped by id % 1000 with the GroupedData shortcut."""
    return (s.range(0, surface_range_rows(sf),
                    num_partitions=SURFACE_RANGE_PARTITIONS)
            .repartition(16).select((F.col("id") % 1000).alias("m"), "id")
            .groupBy("m").sum("id"))


SURFACE_PROGRAMS = {"surface_rollup": surface_rollup,
                    "surface_cube": surface_cube,
                    "surface_repartition": surface_repartition,
                    "surface_distinct": surface_distinct,
                    "surface_dedup_pair": surface_dedup_pair,
                    "surface_dedup_key": surface_dedup_key,
                    "surface_range": surface_range}
SURFACE_WARM_REPS = 1


def null_first(r):
    """Sort key of a row: NULLs first, column by column."""
    return tuple((v is not None, v if v is not None else 0) for v in r)


def sorted_rows(rows) -> list:
    """Rows in null_first order: a plain sort where no row holds a NULL
    (the same order, without a key per row)."""
    if any(None in r for r in rows):
        return sorted(rows, key=null_first)
    return sorted(rows)


def pool_extreme(present, pool, want_min: bool):
    """The smallest or largest pool value marked present (byte order), or
    None."""
    hit = [pool[i] for i in range(len(pool)) if present[i]]
    if not hit:
        return None
    pick = min if want_min else max
    return pick(hit, key=lambda v: v.encode())


def numpy_surface_wants(raw, li: dict, pools: dict) -> dict:
    """Phase 17's rows by numpy: one pass a column over the finest grouping
    set ((flag, status) for the rollup, (status, priority) for the cube,
    with the pool indices of the STRING aggregate inputs), the coarser sets
    summed from those small tables."""
    import numpy as np

    from spark_rapids_tpu_torch.benchmarks import tpch

    def idx(table, name, pool):
        key = f"pool_{name}"
        if key not in pools:
            pools[key] = pool_index(raw[table], name, pool)
        return pools[key]

    out = {}
    flag = np.searchsorted(np.frombuffer("".join(tpch._FLAGS).encode(),
                                         np.uint8), li["l_returnflag"])
    status = np.searchsorted(np.frombuffer("".join(tpch._STATUS).encode(),
                                           np.uint8), li["l_linestatus"])
    nf, ns = len(tpch._FLAGS), len(tpch._STATUS)
    nm, ni = len(tpch._SHIPMODES), len(tpch._INSTRUCT)
    cell = flag * ns + status
    size = nf * ns

    def table(x=None, bins=size, key=cell):
        return np.bincount(key, weights=x, minlength=bins)

    n = table()
    qty = table(li["l_quantity"])
    price = table(li["l_extendedprice"])
    disc = table(li["l_discount"] > 0.05)
    high_tax = table(li["l_tax"] >= 0.02)
    modes = table(bins=size * nm, key=cell * nm + idx(
        "lineitem", "l_shipmode", tpch._SHIPMODES)).reshape(size, nm)
    instr = table(bins=size * ni, key=cell * ni + idx(
        "lineitem", "l_shipinstruct", tpch._INSTRUCT)).reshape(size, ni)
    rows = []
    # rollup(l_returnflag, l_linestatus): both keys, the flag, none
    for keep in ((True, True), (True, False), (False, False)):
        groups = {}
        for f in range(nf):
            for st in range(ns):
                groups.setdefault((f if keep[0] else None,
                                   st if keep[1] else None), []).append(
                    f * ns + st)
        for (f, st), cells in groups.items():
            c = int(n[cells].sum())
            if c == 0:
                continue
            rows.append((tpch._FLAGS[f] if f is not None else None,
                         tpch._STATUS[st] if st is not None else None,
                         float(qty[cells].sum()),
                         float(price[cells].sum() / c),
                         pool_extreme(modes[cells].sum(0) > 0,
                                      tpch._SHIPMODES, True),
                         pool_extreme(instr[cells].sum(0) > 0,
                                      tpch._INSTRUCT, False),
                         bool(disc[cells].sum() > 0),
                         bool(high_tax[cells].sum() == 0), c))
    out["surface_rollup"] = sorted(rows, key=null_first)
    o = table_columns(raw["orders"], ("o_totalprice",))
    ocell = idx("orders", "o_orderstatus", ["F", "O", "P"]) * 5 + idx(
        "orders", "o_orderpriority", tpch._PRIORITIES)
    on = table(bins=15, key=ocell)
    oprice = table(o["o_totalprice"], 15, ocell)
    ncom = len(tpch._O_COMMENTS)
    com = table(bins=15 * ncom, key=ocell * ncom + idx(
        "orders", "o_comment", tpch._O_COMMENTS)).reshape(15, ncom)
    rows = []
    # cube(o_orderstatus, o_orderpriority): both, status, priority, none
    for keep in ((True, True), (True, False), (False, True),
                 (False, False)):
        groups = {}
        for st in range(3):
            for pr in range(5):
                groups.setdefault((st if keep[0] else None,
                                   pr if keep[1] else None), []).append(
                    st * 5 + pr)
        for (st, pr), cells in groups.items():
            c = int(on[cells].sum())
            if c:
                rows.append(("FOP"[st] if st is not None else None,
                             tpch._PRIORITIES[pr] if pr is not None
                             else None, c, float(oprice[cells].sum()),
                             pool_extreme(com[cells].sum(0) > 0,
                                          tpch._O_COMMENTS, False)))
    out["surface_cube"] = sorted(rows, key=null_first)
    fn = n.reshape(nf, ns).sum(1)
    fq = qty.reshape(nf, ns).sum(1)
    out["surface_repartition"] = sorted(
        (tpch._FLAGS[f], int(fn[f]), float(fq[f])) for f in range(nf)
        if fn[f])
    # session.range: ids 0 .. N-1, grouped by id % 1000, in closed form
    rr = surface_range_rows(TPCH_SF)
    m = np.arange(1000, dtype=np.int64)
    cnt = (rr - m + 999) // 1000
    out["surface_range"] = [(int(a), int(c * a + 1000 * c * (c - 1) // 2))
                            for a, c in zip(m, cnt) if c > 0]
    return out


def collect_columns(df) -> list:
    """A query's result as host numpy columns (no Python rows)."""
    import numpy as np

    batches = [b for b in df.toLocalBatches() if b.num_rows]
    if not batches:
        return [np.zeros(0) for _ in df.columns]
    return [np.concatenate([np.asarray(b.columns[i].data)[:b.num_rows]
                            for b in batches])
            for i in range(len(df.columns))]


def exchange_partition_rows(sess, df, n_out: int) -> list:
    """Rows in each output partition of the device exchange of n_out
    partitions in df's plan, counted on the card (nothing is downloaded
    but the counts)."""
    from spark_rapids_tpu_torch.shuffle.exchange import TpuShuffleExchangeExec

    with sess.query_scope():
        plan = sess._physical_plan(df._plan)
        ex = plan.collect_nodes(
            lambda n: isinstance(n, TpuShuffleExchangeExec) and
            n.partitioning.num_partitions == n_out)
        check(len(ex) == 1, f"one device exchange of {n_out} partitions")
        pb = ex[0].execute(sess.exec_context())
        return [sum(int(b.num_rows) for b in pb.iterator(p))
                for p in range(pb.num_partitions)]


def rr_partition_rows(batch_rows, n: int) -> list:
    """Round-robin arithmetic: map partition p's batches of batch_rows[p]
    rows send row r to (r + p) % n."""
    counts = [0] * n
    for p, sizes in enumerate(batch_rows):
        for rows in sizes:
            q, rem = divmod(rows, n)
            for t in range(n):
                counts[t] += q + (1 if (t - p) % n < rem else 0)
    return counts


def row_hash(cols) -> "object":
    """An int64 a row over int64 / float64 host columns (their bits, mixed
    with wrapping multiplies), computed by torch on the card."""
    import numpy as np
    import torch

    h = None
    for i, c in enumerate(cols):
        v = torch.from_numpy(np.ascontiguousarray(c).view(np.int64)).cuda()
        h = v if h is None else h ^ v
        h = h * (0x1E3779B97F4A7C15 + 2 * i)
        h = h ^ (h >> 29)
    return h


def run_surface(sess, raw, tables, li: dict, wants: dict, launches: dict,
                dev, errs: dict) -> dict:
    """Phase 17 (after phase 16, over phase 4's cached SF 10 tables): the
    seven programs of SURFACE_PROGRAMS, one cold and SURFACE_WARM_REPS
    warm runs each, every operator on the card but RangeExec (a host exec,
    as in the reference); rows against numpy; the round-robin partition
    counts against their arithmetic, the hash ones against the CPU
    engine's hash; count(), coalesce, sortWithinPartitions, show and the
    GroupedData shortcuts; K45-K47 and K3's BOOL / any lanes timed at the
    path's shapes ("kernel_rows")."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch import cuda_build as CB
    from spark_rapids_tpu_torch.columnar.dtypes import DataType
    from spark_rapids_tpu_torch.ops import hashing as H
    from spark_rapids_tpu_torch.ops.values import ColV
    from spark_rapids_tpu_torch.plan import functions as F

    t0 = time.perf_counter()
    want = numpy_surface_wants(raw, li, wants.setdefault("pools", {}))
    out = {"numpy_s": time.perf_counter() - t0}
    table_rows = {k: sum(b.num_rows for part in v._plan.partitions
                         for b in part) for k, v in raw.items()}
    for name, fn in SURFACE_PROGRAMS.items():
        q = fn(sess, tables, F, TPCH_SF)
        CB.reset_launch_counts()
        if name in want:
            res = run_query(sess, q, want[name], name, SURFACE_WARM_REPS,
                            order=null_first)
        else:
            # the dedupes: count() runs on the card, rows come as columns
            res = {"cold_s": None, "warm_s": [], "warm_median_s": None}
            torch.cuda.synchronize()
            t = time.perf_counter()
            if name == "surface_dedup_key":
                res["columns"] = collect_columns(q)
            else:
                res["count"] = q.count()
            torch.cuda.synchronize()
            res["cold_s"] = time.perf_counter() - t
            assert_on_device(sess)
        launches[name] = CB.launch_counts()
        tab = {"surface_rollup": "lineitem", "surface_cube": "orders",
               "surface_repartition": "lineitem",
               "surface_distinct": "orders"}.get(name, "lineitem")
        rows_in = surface_range_rows(TPCH_SF) if name == "surface_range" \
            else table_rows[tab]
        res.update(input_rows=rows_in, rows_per_s=rows_in / best_s(res))
        out[name] = res
    # (d) distinct pairs and their partitions
    t = time.perf_counter()
    steps = {}
    last = [t]

    def mark(label):
        now = time.perf_counter()
        steps[label] = now - last[0]
        last[0] = now

    ok, ck = li["l_orderkey"], li["l_partkey"]
    o = table_columns(raw["orders"], ("o_custkey",))
    ost = wants["pools"]["pool_o_orderstatus"]
    pairs = distinct_count(o["o_custkey"] * 3 + ost)
    check(out["surface_distinct"]["count"] == pairs,
          f"distinct: {out['surface_distinct']['count']} pairs, numpy "
          f"{pairs}")
    mark("distinct numpy")
    hashed = exchange_partition_rows(
        sess, surface_distinct(sess, tables, F, TPCH_SF), SURFACE_HASH)
    mark("hash exchange rows")
    # the CPU engine's hash (K4's plain version) over the same keys, as
    # torch ops on the card
    keys_dev = torch.from_numpy(o["o_custkey"]).to(dev)
    ids, _ = H.partition_ids_plain([ColV(
        DataType.INT64, keys_dev, torch.ones_like(keys_dev,
                                                  dtype=torch.bool))],
        None, SURFACE_HASH)
    check(hashed == torch.bincount(ids.long(), minlength=SURFACE_HASH)
          .tolist(),
          f"repartition({SURFACE_HASH}, o_custkey): partition rows "
          f"{hashed} differ from the hash's")
    mark("host hash")
    merged = sess.execute_partitions(
        surface_distinct(sess, tables, F, TPCH_SF).coalesce(2)._plan)
    check(len(merged) == 2 and sum(b.num_rows for p in merged for b in p)
          == pairs, f"coalesce(2): {len(merged)} partitions")
    mark("coalesce")
    # (c) round-robin partition rows
    rr = exchange_partition_rows(
        sess, surface_repartition(sess, tables, F, TPCH_SF), SURFACE_RR)
    li_batches = [[b.num_rows for b in part]
                  for part in raw["lineitem"]._plan.partitions]
    check(rr == rr_partition_rows(li_batches, SURFACE_RR),
          f"repartition({SURFACE_RR}): partition rows {rr}")
    out["partition_rows"] = {"round_robin": rr, "hash": hashed}
    mark("round-robin rows")
    # (e) the dedupes
    pair_n = distinct_count((ok << 21) | ck)
    check(out["surface_dedup_pair"]["count"] == pair_n,
          f"dropDuplicates pair: {out['surface_dedup_pair']['count']} rows,"
          f" numpy {pair_n}")
    mark("pair numpy")
    k_ok, k_pk, k_q, k_p = out["surface_dedup_key"].pop("columns")
    n_keys = distinct_count(ok)
    check(len(k_ok) == n_keys and distinct_count(k_ok) == len(k_ok),
          f"dropDuplicates key: {len(k_ok)} rows, {n_keys} keys")
    check(all_in(row_hash([k_ok, k_pk, k_q, k_p]),
                 row_hash([ok, ck, li["l_quantity"],
                           li["l_extendedprice"]])),
          "dropDuplicates key: a row equals no input row")
    out["surface_dedup_key"]["rows"] = len(k_ok)
    mark("dedupe key check")
    # sortWithinPartitions, show(5), the shortcuts
    head = (tables["orders"].select("o_orderkey", "o_orderstatus")
            .sortWithinPartitions(F.col("o_orderkey").desc()).limit(5))
    top = [r[0] for r in head.collect()]
    first = raw["orders"]._plan.partitions[0][0].num_rows
    check(top == list(range(first - 1, first - 6, -1)),
          f"sortWithinPartitions + limit: {top}, want partition 0's top 5")
    head.show(5)
    mark("sort within, show")
    total = table_rows["orders"]
    check(tables["orders"].count() == total, "orders.count()")
    price = table_columns(raw["orders"], ("o_totalprice",))["o_totalprice"]
    g = tables["orders"].groupBy("o_orderstatus")
    checks = {"sum": np.bincount(ost, weights=price, minlength=3),
              "avg": np.bincount(ost, weights=price, minlength=3) /
              np.bincount(ost, minlength=3)}
    for fn in ("sum", "min", "max", "avg"):
        rows = sorted(getattr(g, fn)("o_totalprice").collect())
        assert_on_device(sess)
        check([r[0] for r in rows] == ["F", "O", "P"],
              f"groupBy.{fn}: keys")
        for r in rows:
            st = "FOP".index(r[0])
            if fn in checks:
                w = float(checks[fn][st])
            else:
                w = float(getattr(np, fn)(price[ost == st]))
            check(abs(r[1] - w) <= TPCH_REL * abs(w),
                  f"groupBy.{fn}: {r} vs numpy {w}")
    mark("shortcuts")
    out["checks_s"] = time.perf_counter() - t
    out["check_steps_s"] = steps
    log(f"phase 17 checks: {steps}")
    out["kernel_rows"] = time_surface_kernels(dev, errs, raw)
    out["phase_s"] = time.perf_counter() - t0
    log(f"phase 17: {out['phase_s']:.1f} s (numpy {out['numpy_s']:.1f} s, "
        f"checks {out['checks_s']:.1f} s)")
    return out


def distinct_count(keys) -> int:
    """Distinct int64 values of a host array, by torch.unique on the card:
    the H100 machine's host sorts 12M keys in numpy in 12.9 s (PERF.md),
    the card in milliseconds; torch.unique is a library call the port
    never uses."""
    import torch

    return int(torch.unique(torch.from_numpy(keys.astype("int64")).cuda())
               .numel())


def all_in(needles, haystack) -> bool:
    """Whether every value of the tensor `needles` is in `haystack`
    (torch.isin on the card, as distinct_count)."""
    import torch

    return bool(torch.isin(needles, haystack).all())


# ------------------------------------- K45-K47, K3 bool / any (phase 3)
def compare_k45(pidx: int, num_rows, cap: int, n: int, dev, label: str,
                errs: dict, route: bool = True) -> None:
    """K45 against its plain version (ids, order, counts), bit for bit."""
    from spark_rapids_tpu_torch.shuffle import exchange as X

    got = X.round_robin_route(pidx, num_rows, cap, n, dev, route)
    rows = int(num_rows)
    want = X.round_robin_route_plain(pidx, rows, cap, n, dev, route)
    for k, (g, w) in enumerate(zip(got, want)):
        check((g is None and w is None) or bits_equal(g, w),
              f"{label}: K45 output {k} differs from its plain version")
    errs.setdefault("round_robin_route", 0.0)


def compare_k46(slices, columns, cap_out: int, label: str,
                errs: dict) -> None:
    from spark_rapids_tpu_torch.shuffle import exchange as X

    got = X.assemble_routed_fixed(slices, columns, cap_out)
    want = X.assemble_routed_fixed_plain(slices, columns, cap_out)
    for k, ((gd, gv), (wd, wv)) in enumerate(zip(got, want)):
        check(bits_equal(gd, wd) and bits_equal(gv, wv),
              f"{label}: K46 column {k} differs from its plain version")
    errs.setdefault("assemble_routed_fixed", 0.0)


def compare_k47(col, valid, gi, cap: int, label: str, errs: dict) -> None:
    """K47 for min and max against its plain version, bit for bit."""
    from spark_rapids_tpu_torch.exec import rowkeys as RK

    offsets, data = col
    for want_min in (True, False):
        got = RK.segment_arg_extreme_string(offsets, data, valid, gi, cap,
                                            want_min)
        want = RK.segment_arg_extreme_string_plain(offsets, data, valid,
                                                   gi.gid, cap, want_min)
        check(bits_equal(got, want), f"{label}: K47 "
              f"{'min' if want_min else 'max'} differs from its plain "
              "version")
    errs.setdefault("segment_arg_extreme_string", 0.0)


def compare_k3_bool(specs, gi, cap: int, label: str, errs: dict) -> None:
    """K3's BOOL min / max and any lanes against the plain version."""
    from spark_rapids_tpu_torch.exec import rowkeys as RK

    got = RK.segment_reduce_many(specs, gi, cap)
    for (op, d, v), (gd, gv) in zip(specs, got):
        wd, wv = RK.segment_reduce_plain(op, d, v, gi, cap)
        check(bits_equal(gd, wd) and bits_equal(gv, wv),
              f"{label}: K3 {op} over {d.dtype} differs from its plain "
              "version")


def int_groups(keys, live, cap: int):
    """A GroupInfo over one int64 key column (K1, K2 on the card)."""
    import torch

    from spark_rapids_tpu_torch.columnar.dtypes import DataType
    from spark_rapids_tpu_torch.exec import rowkeys as RK
    from spark_rapids_tpu_torch.ops.values import ColV

    k = ColV(DataType.INT64, keys, torch.ones_like(live))
    return RK.group_ids_masked([RK.key_proxy(k)], live, cap)


K47_EDGES = [b"", b"", b"a", b"a\x00", b"a\x00b", b"a", b"ab", b"b",
             "é".encode(), b"\xff\xfe", b"\x80", b"abcdefgh", b"abcdefg",
             b"abcdefgh\x00", b"x" * 64 + b"a", b"x" * 64 + b"b",
             b"x" * 64, b"x" * 130 + b"z", b"x" * 130, b"\x00", b"zz"]


def surface_edge_cases(dev, errs: dict) -> int:
    """K45-K47 and K3's BOOL / any lanes bit for bit against their plain
    versions: K45 at 1, 7, 64, 4097, 5000 and 65,536 partitions over 0,
    1, n - 1, n + 3 and 3n + 5 rows, pidx offsets, both modes and a row
    count on the card; K46 over every fixed lane type, one slice, many
    slices of several sources, empty slices; K47 over empty, equal and
    prefix strings, embedded NUL, bytes >= 0x80, strings past 64 and 128
    bytes, NULL rows, all-NULL groups, one group across many chunks, the
    keyless group and a 0-row batch; K3 over BOOL with NULLs and all-NULL
    groups."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.columnar.batch import bucket_capacity
    from spark_rapids_tpu_torch.exec import rowkeys as RK
    from spark_rapids_tpu_torch.shuffle import exchange as X

    sets = 0
    for n in (1, 7, 64, 4097, 5000, 65536):
        for rows in sorted({0, 1, max(n - 1, 0), n + 3, 3 * n + 5}):
            cap = bucket_capacity(max(rows, 1))
            for pidx in (0, 5, n + 2):
                compare_k45(pidx, rows, cap, n, dev,
                            f"K45 n={n} rows={rows} pidx={pidx}", errs)
                sets += 1
            compare_k45(3, torch.tensor(rows, dtype=torch.int32,
                                        device=dev), cap, n, dev,
                        f"K45 n={n} rows={rows} on the card", errs)
            compare_k45(3, rows, cap, n, dev, f"K45 ids n={n} rows={rows}",
                        errs, route=False)
            sets += 2
    rng = np.random.default_rng(1515)
    srcs = []
    for s in range(3):
        cap = 4096 + 512 * s
        n_rows = cap - 100
        cols = [memory_column(rng, t, cap, n_rows, dev)
                for _, t in MEMORY_DTYPES]
        ids = X.rr_ids_plain(s, n_rows, cap, 5, dev)
        order, counts = X.route_plan_plain(ids, 5)
        srcs.append((cols, order, counts.tolist()))
    for label, picks in (("one slice", [(0, 2)]),
                         ("many slices", [(0, 0), (1, 0), (2, 0), (0, 3),
                                          (2, 4), (1, 1)]),
                         ("empty slices", [(0, 5), (1, 2), (2, 5)])):
        slices, columns = [], [[] for _ in MEMORY_DTYPES]
        for s, t in picks:
            cols, order, counts = srcs[s]
            start = sum(counts[:t])
            slices.append((order, start, counts[t]))
            for c, col in enumerate(cols):
                columns[c].append(col)
        total = sum(c for _, _, c in slices)
        compare_k46(slices, columns, bucket_capacity(max(total, 1)),
                    f"K46 {label}", errs)
        sets += 1
    # K47: edge strings in groups, NULLs, an all-NULL group, a long group
    edges = K47_EDGES * 3
    n_rows = len(edges) + 1100
    long_rows = [bytes([97 + (i * 7) % 26]) * (1 + i % 70)
                 for i in range(1100)]
    rows = edges + long_rows
    cap = bucket_capacity(n_rows)
    rows += [b""] * (cap - n_rows)
    offsets, data, _ = raw_string_column(rows, dev)
    key = np.concatenate([np.arange(len(edges)) % 5,
                          np.full(1100, 9), np.zeros(cap - n_rows, int)])
    valid = np.arange(cap) < n_rows
    valid[::13] = False
    valid[key == 4] = False  # an all-NULL group
    live = torch.from_numpy(np.arange(cap) < n_rows).to(dev)
    vt = torch.from_numpy(valid).to(dev) & live
    gi = int_groups(torch.from_numpy(key.astype(np.int64)).to(dev), live,
                    cap)
    compare_k47((offsets, data), vt, gi, cap, "K47 edge strings", errs)
    compare_k47((offsets, data), vt, RK.keyless_group_info(live, cap), cap,
                "K47 keyless", errs)
    empty = torch.zeros(8, dtype=torch.bool, device=dev)
    z_off = torch.zeros(9, dtype=torch.int32, device=dev)
    z_data = torch.zeros(8, dtype=torch.uint8, device=dev)
    compare_k47((z_off, z_data), empty, int_groups(
        torch.zeros(8, dtype=torch.int64, device=dev), empty, 8), 8,
        "K47 0-row batch", errs)
    sets += 3
    # K3: BOOL min / max and any with NULLs and all-NULL groups
    b = torch.from_numpy(rng.random(cap) < 0.3).to(dev)
    bv = vt.clone()
    specs = [("min", b, bv), ("max", b, bv), ("any", b, bv),
             ("min", ~b, live), ("count", b, bv)]
    compare_k3_bool(specs, gi, cap, "K3 bool", errs)
    compare_k3_bool(specs, RK.keyless_group_info(live, cap), cap,
                    "K3 bool keyless", errs)
    compare_k3_bool([("min", z_data.bool(), empty),
                     ("any", z_data.bool(), empty)],
                    int_groups(torch.zeros(8, dtype=torch.int64,
                                           device=dev), empty, 8), 8,
                    "K3 bool 0 rows", errs)
    sets += 3
    return sets


def time_surface_kernels(dev, errs: dict, raw) -> dict:
    """K45 at K45_ROWS rows into SURFACE_RR and K45_MANY partitions (route
    mode); K46 over one 15M-row lineitem partition's fixed columns routed
    round robin into 4 targets from 4 map partitions (target 0's four
    slices, one piece); K47 over the same partition's l_shipinstruct by
    the rollup's first grouping set (l_returnflag, l_linestatus) and by
    its grand total; K3's BOOL min / max / any over l_discount > 0.05 and
    l_tax < 0.02 by the same groups. Each is checked against its plain
    version bit for bit there. Bounds: bytes read once and written once
    (K45: ids, order and counts written, nothing read but the count; K47:
    the group-by's order and ids, the offsets, validity and every byte of
    the strings, one int32 a group slot). Library: a stable torch.sort of
    the ids with a bincount (K45), index_select per column (K46), a
    scatter_reduce_ per column (K3); none computes K47's arg-extreme."""
    import torch

    from spark_rapids_tpu_torch.columnar.batch import (
        HostColumnarBatch,
        bucket_capacity,
    )
    from spark_rapids_tpu_torch.exec import rowkeys as RK
    from spark_rapids_tpu_torch.ops.eval import col_to_colv
    from spark_rapids_tpu_torch.shuffle import exchange as X

    iters, plain_iters = KERNEL_ITERS, PLAIN_ITERS
    rows = {}
    n = K45_ROWS
    for parts in (SURFACE_RR, K45_MANY):
        compare_k45(3, n, n, parts, dev, f"K45 {n} rows, {parts} parts",
                    errs)
        ids = X.rr_ids_plain(3, n, n, parts, dev)
        sfx = "" if parts == SURFACE_RR else f"_{parts}"
        rows[f"k45{sfx}"] = {
            f"ms{sfx}": cuda_ms(lambda: X.round_robin_route(
                3, n, n, parts, dev), iters),
            f"plain_ms{sfx}": cuda_ms(lambda: X.round_robin_route_plain(
                3, n, n, parts, dev), plain_iters),
            f"library_ms{sfx}": cuda_ms(lambda: (
                torch.sort(ids, stable=True),
                torch.bincount(ids, minlength=parts + 1)), plain_iters),
            f"bound_ms{sfx}": bound_ms(8 * n + 4 * (parts + 1)),
            f"shape{sfx}": f"{n} rows, {parts} partitions"}
    rows["round_robin_route"] = {**rows.pop("k45"), **rows.pop(
        f"k45_{K45_MANY}")}
    schema = raw["lineitem"].schema
    part = raw["lineitem"]._plan.partitions[0]
    check(len(part) == 1, "lineitem's first partition is one batch")
    part = part[0]
    fixed = [i for i, a in enumerate(schema) if not a.data_type.is_string]
    batch = HostColumnarBatch([part.columns[i] for i in fixed]).to_device(dev)
    nrows, cap = part.num_rows, batch.capacity
    slices = []
    for p in range(4):
        _, order, counts = X.round_robin_route(p, nrows, cap, 4, dev)
        slices.append((order, 0, int(counts[0])))
    columns = [[(c.data, c.validity)] * 4 for c in batch.columns]
    total = sum(c for _, _, c in slices)
    ocap = bucket_capacity(total)
    compare_k46(slices, columns, ocap, "K46 lineitem piece", errs)
    idx = torch.cat([o[s:s + c].long() for o, s, c in slices])
    flat = [t for c in batch.columns for t in (c.data, c.validity)]
    width = sum(c.data.element_size() + 1 for c in batch.columns)
    rows["assemble_routed_fixed"] = dict(
        ms=cuda_ms(lambda: X.assemble_routed_fixed(slices, columns, ocap),
                   iters),
        plain_ms=cuda_ms(lambda: X.assemble_routed_fixed_plain(
            slices, columns, ocap), plain_iters),
        library_ms=cuda_ms(lambda: [t.index_select(0, idx) for t in flat],
                           plain_iters),
        bound_ms=bound_ms(4 * total + width * total + width * ocap),
        shape=f"{len(slices)} slices, {total} rows x {len(columns)} fixed "
              f"columns (lineitem's) in {ocap} lanes")
    del batch, columns, slices, idx, flat
    names = [a.name for a in schema]
    sb = HostColumnarBatch([part.columns[names.index(c)] for c in (
        "l_returnflag", "l_linestatus", "l_shipinstruct", "l_discount",
        "l_tax")]).to_device(dev)
    flag, status, instr, disc, tax = [col_to_colv(c) for c in sb.columns]
    cap = sb.capacity
    live = torch.arange(cap, device=dev) < nrows
    gi = RK.group_ids_masked([RK.key_proxy(flag), RK.key_proxy(status)],
                             live, cap)
    total_gi = RK.keyless_group_info(live, cap)
    valid = instr.validity & live
    col = (instr.offsets, instr.data)
    compare_k47(col, valid, gi, cap, "K47 l_shipinstruct by the rollup",
                errs)
    compare_k47(col, valid, total_gi, cap, "K47 grand total", errs)
    k47_bytes = 13 * cap + 4 * (cap + 1) + int(instr.offsets[nrows])
    rows["segment_arg_extreme_string"] = dict(
        ms=cuda_ms(lambda: RK.segment_arg_extreme_string(
            *col, valid, gi, cap, False), iters),
        plain_ms=cuda_ms(lambda: RK.segment_arg_extreme_string_plain(
            *col, valid, gi.gid, cap, False), plain_iters),
        library_ms=None, bound_ms=bound_ms(k47_bytes),
        ms_total=cuda_ms(lambda: RK.segment_arg_extreme_string(
            *col, valid, total_gi, cap, False), iters),
        plain_ms_total=cuda_ms(lambda: RK.segment_arg_extreme_string_plain(
            *col, valid, total_gi.gid, cap, False), plain_iters),
        bound_ms_total=bound_ms(k47_bytes),
        shape=f"l_shipinstruct max, {nrows} rows by (l_returnflag, "
              f"l_linestatus); _total: one group")
    d = disc.data > 0.05
    t_ = tax.data < 0.02
    specs = [("max", d, disc.validity & live), ("min", t_,
                                                tax.validity & live)]
    compare_k3_bool(specs, gi, cap, "K3 bool by the rollup", errs)
    any_specs = [("any", d, disc.validity & live)]
    compare_k3_bool(any_specs, gi, cap, "K3 any by the rollup", errs)
    gid = gi.gid.long().clamp(max=cap - 1)

    def library_bool(sp):
        for op, x, _ in sp:
            torch.zeros(cap, dtype=torch.int32, device=dev).scatter_reduce_(
                0, gid, x.to(torch.int32), "amin" if op == "min" else "amax")

    for label, sp in (("bool", specs), ("any", any_specs)):
        rows[f"segment_reduce_{label}"] = dict(
            ms=cuda_ms(lambda: RK.segment_reduce_many(sp, gi, cap), iters),
            plain_ms=cuda_ms(lambda: [RK.segment_reduce_plain(
                op, x, v, gi, cap) for op, x, v in sp], plain_iters),
            library_ms=cuda_ms(lambda: library_bool(sp), plain_iters),
            bound_ms=bound_ms(8 * cap + 4 * len(sp) * cap),
            shape=f"{len(sp)} BOOL columns ({', '.join(op for op, *_ in sp)})"
                  f" x {nrows} rows by (l_returnflag, l_linestatus)")
    del sb
    return rows


# ------------------------------------------------------- phase 18 (slice 16)
# The expressions of slice 16 on the card, over phase 4's cached SF 10
# tables: math, date arithmetic and parts, bitwise ops and shifts, the NULL
# and NaN functions and the arithmetic of abs / signum / negation / div /
# pmod, each grouped to a small result and checked against its reference
# (numpy's datetime64 calendar, the values and groups as torch's own ops
# on the card, apart from K48); a
# scan-form stage with a LocalLimit and one with an Expand against their
# fusion-off rows; monotonically_increasing_id / spark_partition_id
# against their arithmetic and rand against its seed; K48's launches a
# batch of the flagship's and q1's Filter -> Project -> update chain.
EXPR_CONF = {"rapids.tpu.sql.incompatibleOps.enabled": True}
EXPR_WARM_REPS = 0
EXPR_LIMIT = 1000
K48_Q1_ROWS = 15_000_000  # one of q1's four lineitem partitions at SF 10
K48_CHAIN_ROWS = 1 << 22  # the flagship's chain-launch check
K48_FLAGSHIP_ROWS = FLAGSHIP_ROWS // 2  # one cached flagship partition
FUSION_KEY = "rapids.tpu.sql.fusion.enabled"
# the largest ulp gap of each transcendental op, K48 against its plain
# version on the card (phase 3), and the gap the smoke allows: the plain
# versions are torch's CUDA functions over the same libm but cbrt's
# (numpy's, on the host), so a correct kernel sits at 0 to 1
K48_ULP_GAPS: dict = {}
K48_MAX_ULPS = 2


def _expr_cls():
    from spark_rapids_tpu_torch.ops import arithmetic as AR
    from spark_rapids_tpu_torch.ops import bitwise as BW
    from spark_rapids_tpu_torch.ops import nulls as N

    return AR, BW, N


def expr_math(tables, F):
    li = tables["lineitem"]
    price, disc = F.col("l_extendedprice"), F.col("l_discount")
    return (li.groupBy("l_linestatus")
              .agg(F.sum(F.sqrt(price)).alias("sq"),
                   F.sum(F.log1p(price)).alias("lg"),
                   F.sum(F.pow(disc, F.lit(2.0))).alias("pw"),
                   F.sum(F.exp(disc)).alias("ex"),
                   F.sum(F.atan2(disc, F.col("l_tax") + 0.01)).alias("at"),
                   F.max(F.cbrt(price)).alias("cb"),
                   F.sum(F.rint(price / 3.0)).alias("ri"),
                   F.sum(F.degrees(disc)).alias("dg"),
                   F.sum(F.tanh(price / 1e5)).alias("tn"))
              .orderBy("l_linestatus"))


def expr_dates(tables, F):
    d = F.col("o_orderdate")
    return (tables["orders"]
            .select(F.year(d).alias("y"),
                    F.datediff(F.last_day(d), d).alias("dl"),
                    F.dayofweek(d).alias("dw"), F.dayofyear(d).alias("dy"),
                    F.date_add(d, 45).cast("int").alias("da"),
                    F.weekday(d).alias("wd"), F.quarter(d).alias("qt"),
                    F.month(d).alias("mo"))
            .groupBy("y")
            .agg(F.sum("dl").alias("dl"), F.sum("dw").alias("dw"),
                 F.sum("dy").alias("dy"), F.max("da").alias("da"),
                 F.sum("wd").alias("wd"), F.sum("qt").alias("qt"),
                 F.min("mo").alias("mo"), F.count("*").alias("n"))
            .orderBy("y"))


def expr_shipdates(tables, F):
    ship = F.col("l_shipdate")
    return (tables["lineitem"]
            .select(F.month(ship).alias("m"),
                    F.datediff(F.col("l_receiptdate"), ship).alias("dd"),
                    F.to_unix_timestamp(ship.cast("timestamp")).alias("ut"),
                    F.date_sub(ship, F.col("l_quantity").cast("int"))
                    .cast("int").alias("ds"))
            .groupBy("m")
            .agg(F.sum("dd").alias("dd"), F.max("ut").alias("ut"),
                 F.sum("ds").alias("ds"))
            .orderBy("m"))


def expr_bitwise(tables, F):
    AR, BW, N = _expr_cls()
    ok, pk, sk = F.col("l_orderkey"), F.col("l_partkey"), F.col("l_suppkey")
    Col = type(ok)
    return (tables["lineitem"]
            .select("l_linestatus",
                    Col(BW.BitwiseAnd(ok.expr, F.lit(255).expr)).alias("b"),
                    F.shiftright(ok, 3).alias("sr"),
                    F.shiftleft(pk, 2).alias("sl"),
                    F.bitwise_not(sk).alias("bn"),
                    F.shiftrightunsigned(-ok, 60).alias("us"),
                    Col(BW.BitwiseXor(ok.expr, pk.expr)).alias("x"),
                    Col(BW.BitwiseOr(sk.expr, F.lit(1).expr)).alias("o"))
            .groupBy("l_linestatus")
            .agg(F.sum("b").alias("b"), F.sum("sr").alias("sr"),
                 F.sum("sl").alias("sl"), F.sum("bn").alias("bn"),
                 F.sum("us").alias("us"), F.max("x").alias("x"),
                 F.sum("o").alias("o"))
            .orderBy("l_linestatus"))


def expr_nulls(tables, F):
    AR, BW, N = _expr_cls()
    y = F.sqrt(F.col("l_discount") - 0.05)
    Col = type(y)
    # CASE WHEN without ELSE: NULL where the quantity is 25 or less
    x = Col(F.when(F.col("l_quantity") > 25, F.col("l_discount")).expr)
    return (tables["lineitem"]
            .select("l_linestatus", x.alias("x"), y.alias("y"), "l_tax")
            .groupBy("l_linestatus")
            .agg(F.sum(F.isnan(F.col("y")).cast("int")).alias("nan"),
                 F.sum(F.nanvl(F.col("y"), F.lit(-1.0))).alias("nv"),
                 F.sum(F.coalesce(F.col("x"), F.col("l_tax"))).alias("co"),
                 F.sum(Col(N.AtLeastNNonNulls(
                     2, F.col("x").expr, F.col("y").expr,
                     F.col("l_tax").expr)).cast("int")).alias("al"),
                 F.sum(F.col("x").eqNullSafe(0.05).cast("int")).alias("ns"),
                 F.count("x").alias("nx"))
            .orderBy("l_linestatus"))


def expr_arith(tables, F):
    AR, BW, N = _expr_cls()
    ok = F.col("l_orderkey")
    Col = type(ok)
    return (tables["lineitem"]
            .select("l_linestatus",
                    F.abs_(ok - 7_000_000).alias("ab"),
                    F.signum(F.col("l_extendedprice") - 50000.0).alias("sg"),
                    (-F.col("l_partkey")).alias("ng"),
                    Col(AR.IntegralDivide(ok.expr, F.lit(7).expr))
                    .alias("dv"),
                    F.pmod(ok, F.lit(13)).alias("pm"),
                    (F.col("l_suppkey") % -7).alias("rm"),
                    (F.col("l_quantity") % 7.5).alias("fm"))
            .groupBy("l_linestatus")
            .agg(*[F.sum(c).alias(c) for c in ("ab", "sg", "ng", "dv", "pm",
                                               "rm", "fm")])
            .orderBy("l_linestatus"))


EXPR_PROGRAMS = {"expr_math": expr_math, "expr_dates": expr_dates,
                 "expr_shipdates": expr_shipdates,
                 "expr_bitwise": expr_bitwise, "expr_nulls": expr_nulls,
                 "expr_arith": expr_arith}


def expr_limit_stage(tables, F):
    return (tables["lineitem"].filter(F.col("l_quantity") > 45)
            .select("l_orderkey", (F.col("l_extendedprice") * 2)
                    .alias("p2")).limit(EXPR_LIMIT))


def expr_expand_stage(tables, F):
    return (tables["lineitem"].filter(F.col("l_discount") > 0.05)
            .select("l_returnflag", "l_linestatus",
                    (F.col("l_quantity") * 2).alias("q2"))
            .rollup("l_returnflag", "l_linestatus")
            .agg(F.sum("q2").alias("s"), F.count("*").alias("n")))


def _group_sums(key, cols) -> list:
    """(group keys, rows of per-column aggregates) in key order, on the
    card: key a small-range integer tensor, each entry of cols (values,
    'sum' | 'max' | 'min' | 'count'); integer sums exact (int64), float
    sums by index_add_ (another order than the group-by's)."""
    import torch

    lo = int(key.min())
    k = (key.long() - lo)
    counts = torch.bincount(k)
    groups = torch.nonzero(counts).flatten()
    n = len(counts)
    out = []
    for v, op in cols:
        if op == "count":
            red = counts
        elif op in ("max", "min"):
            red = torch.zeros(n, dtype=v.dtype, device=v.device)
            red = red.scatter_reduce(0, k, v, "amax" if op == "max" else
                                     "amin", include_self=False)
        else:
            acc = v.double() if v.is_floating_point() else v.long()
            red = torch.zeros(n, dtype=acc.dtype, device=v.device) \
                .index_add_(0, k, acc)
        out.append(red[groups].tolist())
    return [g + lo for g in groups.tolist()], [
        tuple(c[g] for c in out) for g in range(len(groups))]


def numpy_expr_wants(li: dict, o: dict, dev) -> dict:
    """EXPR_PROGRAMS' rows: the calendar from numpy's datetime64, the
    values and the grouping as torch ops on the card (one torch kernel an
    op, apart from K48)."""
    import numpy as np
    import torch

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    status = up(li["l_linestatus"])
    keys = lambda vals: [chr(v) for v in vals]  # noqa: E731
    price, disc, tax = (up(li[c]) for c in ("l_extendedprice", "l_discount",
                                            "l_tax"))
    q, ok, pk, sk = (up(li[c]) for c in ("l_quantity", "l_orderkey",
                                         "l_partkey", "l_suppkey"))
    want = {}
    vals, rows = _group_sums(status, [
        (torch.sqrt(price), "sum"), (torch.log1p(price), "sum"),
        (torch.pow(disc, 2.0), "sum"), (torch.exp(disc), "sum"),
        (torch.atan2(disc, tax + 0.01), "sum"),
        (torch.pow(price, 1.0 / 3.0), "max"),
        (torch.round(price / 3.0), "sum"), (torch.rad2deg(disc), "sum"),
        (torch.tanh(price / 1e5), "sum")])
    want["expr_math"] = [(k, *r) for k, r in zip(keys(vals), rows)]
    d = o["o_orderdate"].astype(np.int64)
    d64 = d.astype("datetime64[D]")
    month64 = d64.astype("datetime64[M]")
    year64 = d64.astype("datetime64[Y]")
    month = month64.astype(np.int64) % 12 + 1
    last = (month64 + 1).astype("datetime64[D]").astype(np.int64) - 1
    jan1 = year64.astype("datetime64[D]").astype(np.int64)
    dd = up(d)
    vals, rows = _group_sums(up(year64.astype(np.int64) + 1970), [
        (up(last) - dd, "sum"), ((dd + 4) % 7 + 1, "sum"),
        (dd - up(jan1) + 1, "sum"), (dd + 45, "max"), ((dd + 3) % 7, "sum"),
        ((up(month) - 1) // 3 + 1, "sum"), (up(month), "min"),
        (dd, "count")])
    want["expr_dates"] = [(k, *r) for k, r in zip(vals, rows)]
    ship_np = li["l_shipdate"].astype(np.int64)
    ship_m = ship_np.astype("datetime64[D]").astype("datetime64[M]").astype(
        np.int64) % 12 + 1
    ship = up(ship_np)
    vals, rows = _group_sums(up(ship_m), [
        (up(li["l_receiptdate"]).long() - ship, "sum"),
        (ship * 86400, "max"), (ship - q.long(), "sum")])
    want["expr_shipdates"] = [(k, *r) for k, r in zip(vals, rows)]
    us = torch.bitwise_right_shift(-ok, 60) & 15  # >>> 60 of 64 bits
    vals, rows = _group_sums(status, [
        (ok & 255, "sum"), (ok >> 3, "sum"), (pk << 2, "sum"), (~sk, "sum"),
        (us, "sum"), (ok ^ pk, "max"), (sk | 1, "sum")])
    want["expr_bitwise"] = [(k, *r) for k, r in zip(keys(vals), rows)]
    xnull = q <= 25
    y = torch.sqrt(disc - 0.05)
    ynan = torch.isnan(y)
    vals, rows = _group_sums(status, [
        (ynan.long(), "sum"), (torch.where(ynan, -1.0, y), "sum"),
        (torch.where(xnull, tax, disc), "sum"),
        (((~xnull).long() + (~ynan).long() + 1 >= 2).long(), "sum"),
        ((~xnull & (disc == 0.05)).long(), "sum"), ((~xnull).long(), "sum")])
    want["expr_nulls"] = [(k, *r) for k, r in zip(keys(vals), rows)]
    vals, rows = _group_sums(status, [
        ((ok - 7_000_000).abs(), "sum"), (torch.sign(price - 50000.0), "sum"),
        (-pk, "sum"), (ok // 7, "sum"), (ok % 13, "sum"),
        (torch.fmod(sk, -7), "sum"), (torch.fmod(q, 7.5), "sum")])
    want["expr_arith"] = [(k, *r) for k, r in zip(keys(vals), rows)]
    return want


def fused_stage_names(plan) -> list:
    import re

    return re.findall(r"TpuFusedStage\(\d+\)\[[^\]]*\]", plan.tree_string())


def fusion_off_rows(sess, q_of, tables, F, what: str) -> dict:
    """The rows of a scan-form stage with fusion on and off, sorted (NULLs
    first); the on-plan must hold the stage."""
    sess.set_conf(FUSION_KEY, True)
    t = time.perf_counter()
    on = sorted(q_of(tables, F).collect(), key=null_first)
    on_s = time.perf_counter() - t
    stages = fused_stage_names(sess.last_physical_plan)
    assert_on_device(sess)
    sess.set_conf(FUSION_KEY, False)
    try:
        t = time.perf_counter()
        off = sorted(q_of(tables, F).collect(), key=null_first)
        off_s = time.perf_counter() - t
    finally:
        sess.set_conf(FUSION_KEY, True)
    check(on == off, f"{what}: fusion on and off give different rows")
    check(bool(stages), f"{what}: no fused stage in the plan")
    log(f"{what}: {len(on)} rows, stages {stages}, on {on_s:.4f} s, off "
        f"{off_s:.4f} s")
    return {"rows": len(on), "stages": stages, "on_s": on_s, "off_s": off_s}


def kernel_launches(fn) -> int:
    """CUDA kernels fn launches, from torch.profiler's device events other
    than copies and memsets (None when the profiler sees no device
    activity)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    except Exception as e:  # noqa: BLE001 - the count is a report only
        log(f"kernel count: profiler unavailable ({e})")
        return None
    n = sum(1 for e in prof.events()
            if str(getattr(e, "device_type", "")).endswith("CUDA") and
            not e.name.startswith(("Memcpy", "Memset")))
    return n or None


def chain_launches(sess, q_of, what: str) -> dict:
    """K48's launches within each partial-update batch of a Filter ->
    Project -> update chain (one each: the chain is one program), and the
    CUDA kernels a batch launches with fusion on and off."""
    from spark_rapids_tpu_torch import cuda_build as CB
    from spark_rapids_tpu_torch.exec import aggregate as AG

    real = AG._update
    per = []

    def counted(*a, **k):
        before = CB.launch_counts().get("stage_program", 0)
        out = real(*a, **k)
        per.append(CB.launch_counts().get("stage_program", 0) - before)
        return out

    AG._update = counted
    try:
        q_of().collect()
    finally:
        AG._update = real
    check(bool(per) and all(n == 1 for n in per),
          f"{what}: K48 launches per update batch {per}, want 1 each")
    out = {"update_batches": len(per), "k48_per_batch": per[0]}
    for on in (True, False):
        sess.set_conf(FUSION_KEY, on)
        try:
            n = kernel_launches(lambda: q_of().collect())
        finally:
            sess.set_conf(FUSION_KEY, True)
        key = "fusion_on" if on else "fusion_off"
        out[f"{key}_kernels"] = n
        out[f"{key}_kernels_per_batch"] = None if n is None else \
            n / len(per)
    log(f"{what}: {len(per)} update batches, 1 K48 launch each; CUDA "
        f"kernels a batch (whole query / batches): fusion on "
        f"{out['fusion_on_kernels_per_batch']}, off "
        f"{out['fusion_off_kernels_per_batch']}")
    return out


def check_ids(sess, tables, F) -> dict:
    """monotonically_increasing_id is (partition << 33) + the row's index
    in its partition, spark_partition_id the partition; rand(seed) repeats
    and lies in [0, 1)."""
    import numpy as np

    q = tables["orders"].select(F.spark_partition_id().alias("p"),
                                F.monotonically_increasing_id().alias("id"),
                                F.rand(42).alias("r"))
    t = time.perf_counter()
    parts = sess.execute_partitions(q._plan)
    again = sess.execute_partitions(q._plan)
    rows = 0
    for pidx, (part, part2) in enumerate(zip(parts, again)):
        p = np.concatenate([b.columns[0].data for b in part])
        ids = np.concatenate([b.columns[1].data for b in part])
        r = np.concatenate([b.columns[2].data for b in part])
        r2 = np.concatenate([b.columns[2].data for b in part2])
        check(bool((p == pidx).all()), f"spark_partition_id != {pidx}")
        check(np.array_equal(ids, (np.int64(pidx) << 33) + np.arange(
            len(ids), dtype=np.int64)), f"monotonically_increasing_id of "
              f"partition {pidx}")
        check(np.array_equal(r, r2), "rand(42) differs between two runs")
        check(bool(((r >= 0) & (r < 1)).all()), "rand outside [0, 1)")
        rows += len(ids)
    s = time.perf_counter() - t
    log(f"ids: {rows} rows in {len(parts)} partitions match their "
        f"arithmetic; rand(42) repeats, in [0, 1) ({s:.2f} s)")
    return {"rows": rows, "partitions": len(parts), "s": s}


def run_expressions(sess, raw, tables, li: dict, launches: dict, dev,
                    errs: dict) -> dict:
    """Phase 18 (after phase 17, over phase 4's cached SF 10 tables)."""
    from spark_rapids_tpu_torch import cuda_build as CB
    from spark_rapids_tpu_torch.plan import functions as F

    t0 = time.perf_counter()
    o = table_columns(raw["orders"], ("o_orderdate",))
    want = numpy_expr_wants(li, o, dev)
    out = {"wants_s": time.perf_counter() - t0}
    saved = {k: sess.conf.get_key(k) for k in EXPR_CONF}
    for k, v in EXPR_CONF.items():
        sess.set_conf(k, v)
    try:
        for name, fn in EXPR_PROGRAMS.items():
            CB.reset_launch_counts()
            out[name] = run_query(sess, fn(tables, F), want[name], name,
                                  EXPR_WARM_REPS)
            launches[name] = CB.launch_counts()
        CB.reset_launch_counts()
        out["expr_limit_stage"] = fusion_off_rows(
            sess, expr_limit_stage, tables, F, "expr_limit_stage")
        launches["expr_limit_stage"] = CB.launch_counts()
        CB.reset_launch_counts()
        out["expr_expand_stage"] = fusion_off_rows(
            sess, expr_expand_stage, tables, F, "expr_expand_stage")
        launches["expr_expand_stage"] = CB.launch_counts()
        out["ids"] = check_ids(sess, tables, F)
    finally:
        for k, v in saved.items():
            sess.set_conf(k, v)
    from spark_rapids_tpu_torch.benchmarks import tpch

    out["chain_tpch_q1"] = chain_launches(sess, lambda: tpch.q1(tables),
                                          "tpch_q1 chain")
    flag = sess.createDataFrame(flagship_data(K48_CHAIN_ROWS, N_KEYS),
                                [("k", "long"), ("a", "long"),
                                 ("b", "float")], num_partitions=4).cache()
    out["chain_flagship"] = chain_launches(
        sess, lambda: flagship_query(flag), "flagship chain")
    flag.unpersist()
    out["kernel_rows"] = time_stage_program(dev, errs, li)
    out["s"] = time.perf_counter() - t0
    log(f"phase 18: {len(EXPR_PROGRAMS)} programs equal their references, "
        f"the limit and expand stages their fusion-off rows, in "
        f"{out['s']:.1f} s")
    return out


# ----------------------------------------------------- K48 on the card
def k48_battery():
    """Bound expressions of every emittable op family over K48_SCHEMA."""
    from spark_rapids_tpu_torch.columnar.dtypes import DataType as D
    from spark_rapids_tpu_torch.ops import arithmetic as AR
    from spark_rapids_tpu_torch.ops import bitwise as BW
    from spark_rapids_tpu_torch.ops import conditional as CO
    from spark_rapids_tpu_torch.ops import datetimeops as DT
    from spark_rapids_tpu_torch.ops import mathx as MX
    from spark_rapids_tpu_torch.ops import nulls as N
    from spark_rapids_tpu_torch.ops import predicates as P
    from spark_rapids_tpu_torch.ops.base import BoundReference as B
    from spark_rapids_tpu_torch.ops.cast import Cast
    from spark_rapids_tpu_torch.ops.literals import Literal as L

    i, j, f, d = B(0, D.INT64), B(1, D.INT32), B(2, D.FLOAT32), \
        B(3, D.FLOAT64)
    b, dt, ts = B(4, D.BOOL), B(5, D.DATE), B(6, D.TIMESTAMP)
    out = [
        AR.Add(AR.Multiply(i, L(2)), L(1)), AR.Subtract(j, i),
        AR.Multiply(f, d), AR.Divide(i, j), AR.Remainder(i, j),
        AR.Pmod(i, j), AR.Remainder(d, L(3.5)), AR.Pmod(j, L(-3)),
        AR.IntegralDivide(i, j), AR.UnaryMinus(i), AR.Abs(j),
        AR.Signum(d), AR.Signum(j), AR.Abs(f),
        P.LessThan(f, L(0.9)), P.EqualTo(f, L(0.9)), P.GreaterThan(i, d),
        P.LessThanOrEqual(i, L(5_000_000_000)),
        P.And(P.GreaterThan(j, L(0)), b), P.Or(N.IsNull(i), P.Not(b)),
        P.In(j, [L(1), L(2), L(None, D.INT32)]), P.In(f, [L(0.5), L(1)]),
        P.EqualNullSafe(i, j), P.EqualNullSafe(f, L(0.9)),
        N.IsNull(f), N.IsNotNull(d), N.IsNan(f), N.NaNvl(d, L(1.0)),
        N.Coalesce(j, i, L(7)), N.AtLeastNNonNulls(2, i, f, d),
        CO.If(b, i, L(3)),
        CO.CaseWhen([(P.GreaterThan(j, L(0)), L(1.5)), (b, f)], L(0)),
        MX.Rint(d), MX.ToDegrees(f), MX.NormalizeNaNAndZero(d),
        MX.Floor(d), MX.Ceil(f),
        BW.BitwiseAnd(i, L(7)), BW.BitwiseXor(j, i), BW.BitwiseNot(j),
        BW.ShiftLeft(i, L(65)), BW.ShiftLeft(j, j), BW.ShiftRight(j, j),
        BW.ShiftRightUnsigned(i, L(3)), BW.ShiftRightUnsigned(j, L(-1)),
        DT.Year(dt), DT.Month(ts), DT.DayOfMonth(dt), DT.Quarter(dt),
        DT.Hour(ts), DT.Minute(ts), DT.Second(ts), DT.DayOfYear(dt),
        DT.LastDay(dt), DT.DayOfWeek(ts), DT.WeekDay(dt),
        DT.DateAdd(dt, L(30)), DT.DateSub(dt, j), DT.DateDiff(dt, L(100)),
        DT.UnixTimestamp(ts), DT.ToUnixTimestamp(dt), DT.FromUnixTime(i),
        Cast(d, D.INT32), Cast(f, D.INT64), Cast(i, D.FLOAT32),
        Cast(dt, D.TIMESTAMP), Cast(ts, D.DATE), Cast(d, D.BOOL),
        Cast(i, D.INT8), Cast(j, D.INT16)]
    math = [MX.Sqrt(d), MX.Sin(f), MX.Sin(d), MX.Cos(d), MX.Tan(d),
            MX.Asin(f), MX.Acos(d), MX.Atan(d), MX.Sinh(d), MX.Cosh(d),
            MX.Tanh(d), MX.Asinh(d), MX.Acosh(d), MX.Atanh(f), MX.Cbrt(d),
            MX.Exp(d), MX.Expm1(d), MX.Log(d), MX.Log1p(d), MX.Log2(d),
            MX.Log10(i), MX.Cot(d), MX.Pow(d, L(2.5)), MX.Atan2(f, d),
            MX.Logarithm(L(3.0), d)]
    return out, math


def k48_columns(n: int, cap: int, seed: int, dev, all_null: bool = False):
    """ColV inputs of K48_SCHEMA on the card: NULLs, NaN, +-0, INT64_MIN,
    INT32 extremes, divisors 0 and -1, shift amounts past the width."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.columnar.dtypes import DataType as D
    from spark_rapids_tpu_torch.ops.values import ColV

    rng = np.random.default_rng(seed)
    i = rng.integers(-1000, 1000, cap).astype(np.int64)
    j = rng.integers(-40, 80, cap).astype(np.int32)
    f = (rng.normal(size=cap) * 2).astype(np.float32)
    d = rng.normal(size=cap) * 50
    edges_i = [-(1 << 63), -1, 0, 1 << 62, (1 << 63) - 1, 7, 64, 65]
    edges_j = [0, -1, -(1 << 31), (1 << 31) - 1, 70, 32, 31, -3]
    edges_f = [np.nan, -0.0, 0.0, np.float32(0.9), 0.5, np.inf, -np.inf, 1e30]
    edges_d = [np.nan, -0.0, 0.0, np.inf, 1e300, -2.5, -np.inf, 5e-324]
    k = min(8, cap)
    i[:k], j[:k] = edges_i[:k], edges_j[:k]
    f[:k], d[:k] = np.array(edges_f[:k], np.float32), edges_d[:k]
    b = rng.random(cap) > 0.5
    dt = rng.integers(-30000, 30000, cap).astype(np.int32)
    ts = rng.integers(-(10 ** 15), 10 ** 15, cap).astype(np.int64)
    cols = []
    for arr, t in ((i, D.INT64), (j, D.INT32), (f, D.FLOAT32),
                   (d, D.FLOAT64), (b, D.BOOL), (dt, D.DATE),
                   (ts, D.TIMESTAMP)):
        valid = (rng.random(cap) > 0.15) & (np.arange(cap) < n)
        if all_null:
            valid[:] = False
        data = torch.from_numpy(np.where(valid, arr, np.zeros((), arr.dtype))
                                ).to(dev)
        cols.append(ColV(t, data, torch.from_numpy(valid).to(dev)))
    return cols


def ulp_gap(a, b) -> int:
    """The largest gap in units in the last place between two float
    tensors (NaN equal to NaN)."""
    import torch

    if a.dtype == torch.float32:
        ia, ib = a.view(torch.int32).long(), b.view(torch.int32).long()
    else:
        ia, ib = a.view(torch.int64), b.view(torch.int64)
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    d = torch.where(same, torch.zeros_like(ia), (ia - ib).abs())
    return int(d.max()) if d.numel() else 0


def compare_k48(plan, ctx, label: str, errs: dict, math_op=None) -> None:
    """One StagePlan's programs: the kernel against the plain version on
    the same inputs, bit for bit (any NaN equal); a transcendental output
    records its ulp gap under its op instead."""
    import torch

    from spark_rapids_tpu_torch.ops import program as PG

    for prog, _ in plan.programs:
        ins = plan.inputs(ctx, prog)
        got, gk = PG.stage_program(prog, ins, ctx.num_rows, ctx.capacity,
                                   ctx.device)
        want, wk = PG.run_plain(prog, ins, ctx.num_rows, ctx.capacity,
                                ctx.device)
        check((gk is None) == (wk is None) and (
            gk is None or torch.equal(gk, wk)), f"{label}: keep masks differ")
        for (gd, gv), (wd, wv) in zip(got, want):
            check(torch.equal(gv, wv), f"{label}: validity differs")
            if math_op is not None and gd.is_floating_point():
                # an op over a FLOAT input computes at float32 and stores
                # widened: its gap counts in float32 ulps
                if "FLOAT32" in math_op:
                    gd, wd = gd.float(), wd.float()
                n = ulp_gap(gd, wd)
                K48_ULP_GAPS[math_op] = max(K48_ULP_GAPS.get(math_op, 0), n)
                check(n <= K48_MAX_ULPS, f"{label}: {math_op} is {n} ulps "
                      f"from its plain version (at most {K48_MAX_ULPS})")
                continue
            same = bits_equal(gd, wd) or (gd.is_floating_point() and bool(
                ((gd == wd) | (torch.isnan(gd) & torch.isnan(wd))).all()))
            check(same, f"{label}: data differs")
            errs["stage_program"] = max(errs.get("stage_program", 0.0),
                                        max_abs_err(gd, wd))


def stage_program_edge_cases(dev, errs: dict) -> int:
    """K48 against its plain version on the card: every emittable op
    family over edge inputs, a 0-row, an all-NULL and a lazily counted
    batch; the transcendental functions record their ulp gaps
    (K48_ULP_GAPS)."""
    import torch

    from spark_rapids_tpu_torch.ops import program as PG
    from spark_rapids_tpu_torch.ops.values import EvalContext

    exact, math = k48_battery()
    sets = 0
    for n, cap, all_null, seed in ((4000, 4096, False, 1),
                                   (0, 8, False, 2), (300, 512, True, 3),
                                   (5, 8, False, 4)):
        cols = k48_columns(n, cap, seed, dev, all_null)
        rows = n if seed != 4 else torch.tensor(n, dtype=torch.int32,
                                                device=dev)
        ctx = EvalContext(True, cols, rows, cap, device=dev)
        label = f"K48 n={n} cap={cap}{' all-NULL' if all_null else ''}"
        compare_k48(PG.StagePlan(exact), ctx, label, errs)
        compare_k48(PG.StagePlan([], exact[14:30]), ctx, label + " keep",
                    errs)
        for e in math:
            compare_k48(PG.StagePlan([e]), ctx, f"{label} {type(e).__name__}",
                        errs, math_op=f"{type(e).__name__}"
                        f"({e.children()[0].data_type.name})")
        sets += 3
    log(f"K48: ulp gaps of the transcendental ops against torch's CUDA "
        f"functions: {K48_ULP_GAPS}")
    return sets


def time_stage_program(dev, errs: dict, li: dict) -> dict:
    """K48 at q1's update shape (the folded filter and the two computed
    inputs over one K48_Q1_ROWS-row lineitem partition) and at the
    flagship's (filter and c = a * 2 + 1 over a 2^25-row partition), each
    against its plain version on the same inputs."""
    import torch

    from spark_rapids_tpu_torch.columnar.dtypes import DataType as D
    from spark_rapids_tpu_torch.ops import arithmetic as AR
    from spark_rapids_tpu_torch.ops import predicates as P
    from spark_rapids_tpu_torch.ops import program as PG
    from spark_rapids_tpu_torch.ops.base import BoundReference as B
    from spark_rapids_tpu_torch.ops.literals import Literal as L
    from spark_rapids_tpu_torch.ops.values import ColV, EvalContext

    def ctx_of(arrays, types, n):
        cols = []
        for a, t in zip(arrays, types):
            data = torch.from_numpy(a[:n]).to(dev)
            cols.append(ColV(t, data, torch.ones(n, dtype=torch.bool,
                                                 device=dev)))
        return EvalContext(True, cols, n, n, device=dev)

    n = min(K48_Q1_ROWS, len(li["l_shipdate"]))
    from spark_rapids_tpu_torch.benchmarks.tpch import _days

    ctx = ctx_of([li["l_shipdate"], li["l_extendedprice"],
                  li["l_discount"], li["l_tax"]],
                 (D.DATE, D.FLOAT64, D.FLOAT64, D.FLOAT64), n)
    ship, price, disc, tax = B(0, D.DATE), B(1, D.FLOAT64), \
        B(2, D.FLOAT64), B(3, D.FLOAT64)
    disc_price = AR.Multiply(price, AR.Subtract(L(1), disc))
    q1 = PG.StagePlan(
        [disc_price, AR.Multiply(disc_price, AR.Add(L(1), tax))],
        [P.LessThanOrEqual(ship, L(_days("1998-09-02"), D.DATE))])
    compare_k48(q1, ctx, "K48 q1 update shape", errs)
    prog = q1.program
    ins = q1.inputs(ctx)
    row = dict(
        ms=cuda_ms(lambda: PG.stage_program(prog, ins, n, n, dev),
                   KERNEL_ITERS),
        plain_ms=cuda_ms(lambda: PG.run_plain(prog, ins, n, n, dev),
                         PLAIN_ITERS),
        library_ms=None,
        # read 4 columns (data + validity), write 2 (data + validity) and
        # the keep mask
        bound_ms=bound_ms((4 + 1 + 3 * (8 + 1) + 2 * (8 + 1) + 1) * n),
        shape=f"q1 update: 1 filter + 2 outputs over {n} rows")
    fn = K48_FLAGSHIP_ROWS
    data = flagship_data(fn, N_KEYS)
    fctx = ctx_of([data["a"], data["b"]], (D.INT64, D.FLOAT32), fn)
    a, b = B(0, D.INT64), B(1, D.FLOAT32)
    flag = PG.StagePlan(
        [AR.Add(AR.Multiply(a, L(2)), L(1))],
        [P.And(P.Not(P.EqualTo(AR.Remainder(a, L(3)), L(0))),
               P.LessThan(b, L(0.9)))])
    compare_k48(flag, fctx, "K48 flagship shape", errs)
    fprog = flag.program
    fins = flag.inputs(fctx)
    row.update(
        ms_flagship=cuda_ms(lambda: PG.stage_program(fprog, fins, fn, fn,
                                                     dev), KERNEL_ITERS),
        plain_ms_flagship=cuda_ms(lambda: PG.run_plain(fprog, fins, fn, fn,
                                                       dev), PLAIN_ITERS),
        bound_ms_flagship=bound_ms((8 + 1 + 4 + 1 + 8 + 1 + 1) * fn),
        shape_flagship=f"flagship: 1 filter + 1 output over {fn} rows")
    log(f"K48: q1 shape {row['ms']:.4f} ms (bound {row['bound_ms']:.4f}, "
        f"plain {row['plain_ms']:.4f}); flagship shape "
        f"{row['ms_flagship']:.4f} ms (bound {row['bound_ms_flagship']:.4f},"
        f" plain {row['plain_ms_flagship']:.4f})")
    return {"stage_program": row}



def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="trace one warm flagship, q1, q3 and q5 query, "
                         "the two slowest of phase 6, q05 and the two "
                         "slowest of phase 7, q_percentiles and "
                         "q_delinquency of phase 8, the Parquet q1 and "
                         "the encoded q_agg and q1 over dictionary files "
                         "and q05 and q02 over v2 Parquet, each with "
                         "torch.profiler and cProfile and write their "
                         "device kernel and host function tables to DIR")
    ap.add_argument("--out", default=None,
                    help="also write the results as JSON to this file")
    ap.add_argument("--q02-probe", default=None, metavar="SF,SF,...",
                    help="instead of the phases, run TPCx-BB q02 alone at "
                         "each scale factor (ascending, up to the first "
                         "that runs out of device memory) and print its "
                         "times and peak device memory as one JSON line")
    ap.add_argument("--mortgage-probe", default=None, metavar="SF,SF,...",
                    help="the same for the mortgage q_delinquency_12")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "spark_rapids_tpu_torch")):
        print("chip_smoke: spark_rapids_tpu_torch is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    import spark_rapids_tpu_torch as srt
    from spark_rapids_tpu_torch import cuda_build as CB

    if torch.cuda.device_count() < 1:
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi unavailable"
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    t = time.perf_counter()
    for line in CB.build_all(verbose=True):
        log(line[:4000])
    build_s = time.perf_counter() - t
    log(f"kernels built in {build_s:.1f} s")
    probes = {"q02_probe": (args.q02_probe, probe_q02),
              "mortgage_probe": (args.mortgage_probe, probe_d12)}
    for key, (sfs, probe) in probes.items():
        if sfs:
            print(card)
            print(json.dumps({key: probe([float(x) for x in sfs.split(",")]),
                              "total_memory": torch.cuda.get_device_properties(
                                  0).total_memory}))
            return 0

    errs: dict = {}
    results = {"card": card, "build_s": build_s}
    start_counters = memory_totals()
    n_edge = edge_cases(dev, errs) + string_edge_cases(dev, errs) + \
        join_edge_cases(dev, errs) + search_edge_cases(dev, errs) + \
        window_edge_cases(dev, errs) + string_chars_edge_cases(dev, errs) + \
        slice6_edge_cases(dev, errs) + parquet_edge_cases(dev, errs) + \
        encoded_edge_cases(dev, errs) + parquet_v2_edge_cases(dev, errs) + \
        orc_edge_cases(dev, errs) + memory_edge_cases(dev, errs) + \
        csv_edge_cases(dev, errs) + string_transform_edge_cases(dev, errs) + \
        cast_edge_cases(dev, errs) + surface_edge_cases(dev, errs) + \
        stage_program_edge_cases(dev, errs)
    log(f"phase 3 edge cases: {n_edge} input sets match their plain "
        f"versions")
    results["k48_ulp_gaps"] = K48_ULP_GAPS
    sess = srt.new_session({"rapids.tpu.sql.test.enabled": True})
    launches = {}
    CB.reset_launch_counts()
    results["phase1"] = run_flagship(sess, FLAGSHIP_ROWS, N_KEYS,
                                     "phase 1 flagship", 3)
    launches["flagship"] = CB.launch_counts()
    CB.reset_launch_counts()
    results["phase2"] = run_flagship(sess, HIGH_CARD_ROWS, HIGH_CARD_KEYS,
                                     "phase 2 high cardinality", 1)
    launches["high_cardinality"] = CB.launch_counts()
    tpch_sess = srt.new_session(TPCH_CONF)
    wants: dict = {}
    results["phase4"], raw, tables, li = run_tpch(tpch_sess, launches,
                                                  args.profile, wants)
    results["phase5"] = run_joins(tpch_sess, raw, tables, li, launches,
                                  args.profile, wants)
    results["phase6"] = run_queries(tpch_sess, raw, tables, li, launches,
                                    args.profile, wants)
    results["strings"] = run_strings(tpch_sess, raw, tables, li, wants,
                                     launches, dev, errs)
    string_rows = results["strings"].pop("kernel_rows")
    results["casts"] = run_casts(tpch_sess, raw, tables, li, launches, dev,
                                 errs)
    cast_rows = results["casts"].pop("kernel_rows")
    results["surface"] = run_surface(tpch_sess, raw, tables, li, wants,
                                     launches, dev, errs)
    surface_rows = results["surface"].pop("kernel_rows")
    results["expressions"] = run_expressions(tpch_sess, raw, tables, li,
                                             launches, dev, errs)
    expr_rows = results["expressions"].pop("kernel_rows")
    results["parquet"] = run_parquet(tpch_sess, raw, tables, wants,
                                     wants["input_rows"], launches,
                                     args.profile)
    v2_samples = {"l_extendedprice": results["parquet"].pop(
        "l_extendedprice_sample")}
    results["orc"] = run_orc(tpch_sess, raw, tables, wants,
                             wants["input_rows"], launches, args.profile)
    enc_root = tempfile.mkdtemp(prefix="chip_smoke_encoded_")
    try:
        results["encoded"], bench = run_encoded(
            tpch_sess, raw, wants, launches, enc_root, args.profile)
        results["compressed"] = run_compressed(
            tpch_sess, tables, wants, bench, enc_root, launches)
    finally:
        shutil.rmtree(enc_root, ignore_errors=True)
    del bench
    for df in tables.values():
        df.unpersist()
    tpch_sess.last_physical_plan = None
    torch.cuda.empty_cache()
    before = memory_totals()
    results["memory"] = run_memory(raw, wants, launches)
    phase13_faults = fault_counts(before)
    del raw, tables, li
    torch.cuda.empty_cache()
    results["csv"] = run_csv(launches, dev, errs)
    csv_rows = results["csv"].pop("kernel_rows")
    results["phase6_small_sf"] = run_small_sf()
    torch.cuda.empty_cache()
    results["phase7"], pr_content, samples = run_tpcxbb(launches,
                                                        args.profile)
    v2_samples.update(samples)
    results["phase7_small_sf"] = run_xbb_small_sf()
    torch.cuda.empty_cache()
    results["phase8"] = run_mortgage(launches, args.profile)
    results["phase8_small_sf"] = run_mortgage_small_sf()
    results["launches"] = launches
    log(f"launches: {launches}")
    if args.profile:
        results["profile"] = profile_flagship(sess, FLAGSHIP_ROWS,
                                              args.profile)
    kernels = time_kernels(dev, errs, launches, pr_content, d12_batch_rows(
        results["phase8"]["mortgage_q_delinquency_12"]["joins"]), v2_samples,
        {**csv_rows, **string_rows, **cast_rows, **surface_rows,
         **expr_rows})
    results["kernels"] = kernels
    # no run outside phase 13 (timed or not) retried, split or fell back
    every = fault_counts(start_counters)
    results["fault_counters"] = {
        "phase13": phase13_faults,
        "outside_phase13": {k: every[k] - phase13_faults[k]
                            for k in FAULT_COUNTERS}}
    check(not any(results["fault_counters"]["outside_phase13"].values()),
          f"a run outside phase 13 left the device path: "
          f"{results['fault_counters']}")
    results["total_s"] = time.perf_counter() - T0
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(results, fh, indent=1)
    if "left_out" in results["phase7"]["parquet_v2"]:
        PATH_KERNELS.pop("parquet_v2_xbb_q02")
    for path, names in PATH_KERNELS.items():
        for name in names:
            check(launches[path].get(name, 0) > 0,
                  f"{name} never launched in the {path} run")
    print(card)
    p4, p5, p6 = results["phase4"], results["phase5"], results["phase6"]
    keep = ("cold_s", "warm_s", "warm_median_s", "rows", "rows_per_s",
            "input_rows", "checked_against", "joins")
    print(json.dumps({"flagship": {k: results["phase1"][k] for k in (
        "rows", "groups", "cold_s", "warm_s", "warm_median_s")},
        "high_cardinality": {k: results["phase2"][k] for k in (
            "rows", "groups", "cold_s", "warm_median_s")},
        "tpch": {"sf": p4["sf"], "lineitem_rows": p4["lineitem_rows"],
                 "gen_s": p4["gen_s"], "device_bytes": p4["device_bytes"],
                 **{q: p4[q] for q in ("tpch_q1", "tpch_q6",
                                       "tpch_q1_routed")},
                 **{q: p5[q] for q in ("tpch_q3", "tpch_q5",
                                       "tpch_q5_shuffled")},
                 **{f"tpch_{q}": {k: v for k, v in p6[f"tpch_{q}"].items()
                                  if k in keep} for q in NEW_QUERIES}},
        "small_sf": results["phase6_small_sf"],
        "tpcxbb": {k: ({kk: vv for kk, vv in v.items() if kk in keep +
                        ("tables", "sf")} if k.startswith("tpcxbb_") else v)
                   for k, v in results["phase7"].items()
                   if k != "parquet_v2"},
        "parquet_v2": {k: ({kk: vv for kk, vv in v.items() if kk in keep +
                            ("tables", "last_run_scan_host_s")}
                           if k.startswith("parquet_v2_") else v)
                       for k, v in results["phase7"]["parquet_v2"].items()},
        "tpcxbb_small_sf": results["phase7_small_sf"],
        "mortgage": {k: ({kk: vv for kk, vv in v.items() if kk in keep +
                          ("tables", "sf", "peak_bytes")}
                         if k.startswith("mortgage_") else v)
                     for k, v in results["phase8"].items()},
        "mortgage_small_sf": results["phase8_small_sf"],
        "parquet": {k: ({kk: vv for kk, vv in v.items() if kk in keep + (
            "last_run_scan_host_s", "last_run_rest_s", "gbps",
            "file_bytes")} if k.startswith("parquet_") else v)
            for k, v in results["parquet"].items()},
        "orc": {k: ({kk: vv for kk, vv in v.items() if kk in keep + (
            "last_run_scan_host_s", "runs", "rows", "bytes", "s")}
            if k.startswith(("orc_", "lineitem_")) else v)
            for k, v in results["orc"].items()},
        "encoded": {k: ({kk: vv for kk, vv in v.items() if kk in keep + (
            "encodedColumns", "lateMaterializations", "k23_launches",
            "k24_launches", "k4_code_launches", "peak_device_bytes",
            "scan_host_s", "speedup_vs_off")}
            if k.startswith("encoded_") else v)
            for k, v in results["encoded"].items()},
        "compressed": {k: ({kk: vv for kk, vv in v.items() if kk in keep + (
            "runCollapsedRows", "k48_max_lanes", "orderPreservingSorts",
            "window_batches", "rank_remaps", "k24_rank_launches",
            "k24_launches",
            "serialized_bytes", "serialized_string_col_bytes",
            "host_store_bytes", "fetchRetries", "unserialized_s")}
            if k.startswith(("compressed_", "serialized_")) else v)
            for k, v in results["compressed"].items()},
        "memory": results["memory"],
        "csv": {k: ({kk: vv for kk, vv in v.items() if kk in keep + (
            "last_run_scan_host_s", "csv_host_splits")}
            if k.startswith("csv_") else v)
            for k, v in results["csv"].items()},
        "strings": {k: ({kk: vv for kk, vv in v.items() if kk in keep}
                        if k.startswith("strings_") else v)
                    for k, v in results["strings"].items()},
        "casts": {k: ({kk: vv for kk, vv in v.items() if kk in keep + (
            "python_check_s",)} if k.startswith("casts_") else v)
            for k, v in results["casts"].items()},
        "surface": {k: ({kk: vv for kk, vv in v.items() if kk in keep + (
            "count",)} if k.startswith("surface_") else v)
            for k, v in results["surface"].items()},
        "expressions": {k: ({kk: vv for kk, vv in v.items() if kk in keep}
                            if k in EXPR_PROGRAMS else v)
                        for k, v in results["expressions"].items()},
        "k48_ulp_gaps": K48_ULP_GAPS,
        "fault_counters": results["fault_counters"],
        "total_s": time.perf_counter() - T0}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
