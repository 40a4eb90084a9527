"""Measurement tools of the port: per-kernel benchmarks (``ops_bench``), the
decode-GEMV variant probe (``qmv_probe``), the decode-attention routing probe
(``flash_decode_probe``), the pp/tg perf matrix (``llama_bench``) and the
GGUF shard / merge tool (``gguf_split``)."""
