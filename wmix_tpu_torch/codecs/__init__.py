"""MP3 and AAC decoding: host bitstream front-ends, batched device transforms.

Port of `wmix_tpu/codecs/`'s batched decode path.  The device halves are
torch programs over B streams: `mp3_batch` (the MP3 polyphase synthesis,
`BatchedSynth`, and `Mp3BatchDecoder`) and `aac_batch` (the AAC-LC IMDCT
and window/overlap filterbank, `BatchedFilterbank`, and `AacBatchDecoder`).
The host halves are copies of the reference's numpy decoders (`mp3`,
`aac` with `sbr` and `ps`, `adts`), of their generated tables, and of the
ctypes wrappers over the C front-ends (`mp3fe`, `aacfe`, built by
`wmix_tpu_torch.native`).
"""
