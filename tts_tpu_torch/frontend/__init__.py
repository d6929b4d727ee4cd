"""Text frontends (copies of tts_tpu/frontend): F5's (with a jieba-free path
for ASCII text), `hf_tokenizer`, `spm`, `normalize`, `indextts_text` and
`voxcpm_text`."""
