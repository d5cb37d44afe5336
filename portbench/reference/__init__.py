"""The plain reference the benchmark holds the port to.

Plain PyTorch in float32 with TF32 off: the DistilBERT and BERT forward
(``encoder``), the hash tokenizer and the collation (``text``), the
dropout masks worked out again from the training seed (``dropout``), the
lambda_mrr loss, clipping and AdamW followed step by step (``train``),
and per-row int8 quantization with a blocked exact top-k (``search``).
It imports nothing of the port, of the JAX package or of JAX, and takes
nothing the port made: it is handed the benchmark's own inputs (texts,
weights, store rows) and works out again whatever the port derived from
them. ``quant`` arguments switch on the control: every product's
operands rounded to fp8 (e4m3, a per-tensor scale), the precision below
the configurations' bf16.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
