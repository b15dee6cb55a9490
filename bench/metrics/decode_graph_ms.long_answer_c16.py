"""``decode_graph_ms`` in ``stablelm_3b.long_answer_c16``, whose
end-to-end metrics have bounds of their own."""
from bench.harness import reader

read = reader("decode_graph_ms")
