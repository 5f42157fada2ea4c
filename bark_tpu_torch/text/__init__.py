from bark_tpu_torch.text.tokenizer import (  # noqa: F401
    Vocab,
    strip_accents,
    bert_tokenize,
    tokenize_input,
)
