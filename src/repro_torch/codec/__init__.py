from repro_torch.codec.tvc import (  # noqa: F401
    CODEC_ALIASES,
    HEADER_PROBE_BYTES,
    TIERS,
    EncodedGOP,
    Tier,
    canonical_codec,
    decode_gop,
    deserialize_gop,
    encode_gop,
    is_compressed_codec,
    parse_gop_header,
    prefix_gop,
    serialize_gop,
    transcode_gop,
)
from repro_torch.codec.gop import (  # noqa: F401
    UNCOMPRESSED_BLOCK_BYTES,
    split_into_gops,
)
