"""repro_torch.compress — compressed-gradient robust aggregation (port of
``repro.compress``, DESIGN.md §14): a codec registry between per-worker
gradients and robust aggregation, the ``CompressionSpec`` scenario axis, and
the encode -> wire attack -> decode -> reduce pipeline.
"""
from repro_torch.compress.codecs import (DenseCodec, Int8Codec,  # noqa: F401
                                         SignBitCodec, TopKCodec)
from repro_torch.compress.pipeline import (  # noqa: F401
    ENCODED_ATTACKS, aggregate_compressed, aggregate_compressed_tree,
    bytes_per_round, corrupt_payload, roundtrip_matrix)
from repro_torch.compress.spec import (Codec, CompressError,  # noqa: F401
                                       CompressionSpec, available_codecs,
                                       get_codec, make_codec, register_codec,
                                       validate_compression)
