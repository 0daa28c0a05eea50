"""moshi_tpu_torch — the PyTorch / CUDA (Hopper) port of moshi_tpu.

Same layout and names as ``moshi_tpu`` so each module's counterpart is easy
to find; plain tensor code is PyTorch, and every Pallas kernel on the
ported path is a hand-written CUDA C++ kernel for ``sm_90a`` under
``csrc/`` (built on first use by ``kernels/build.py``).

Slices 1 and 2 cover the full-duplex speech-to-speech frame
(``runtime.pipeline.STSPipeline``): the Mimi codec (``models.mimi``:
SEANet, its T = 2 transformers, the split RVQ) around the Moshi LM frame
step (``models.lm.lm_gen_step``) with q4_k weights: embeddings, the
stacked temporal decode, the text head and sampling, the stacked
depformer, the delay cache, and the fused mid-layer kernel of both
stacks.  Slice 3 adds the speech-to-text frame
(``runtime.pipeline.STTPipeline``): a dense bf16 LM with dep_q = 0 and a
VAD head (``LMConfig.from_moshi_config`` of a ``config.json`` read by
``config.load_config``), whose temporal stack takes the generic layer
path at T = 1 (decode attention and ring write over 4-D rings).  Slice 4
serves several full-duplex sessions in one frame
(``runtime.serving.SessionPool``, sized by ``auto_slots`` from the card's
memory): at B > 1 the LM's products take the dequant matvecs, the flat
one for the text head and the depformer in-projection and the fused GLU
for the q4_k feed-forwards.  Slice 5 adds text-to-speech with the
voice-conditioned, cross-attention TTS class: ``runtime.pipeline
.TTSPipeline`` (the text StateMachine on the host or on the device),
``models.tts.TTSModel`` and ``runtime.serving.TTSSessionPool``, whose
temporal GLUs at B > 1 take the flat dequant GLU; the depformer takes a
generic form where its weights are dense; and the int8 kernels take up to
8 rows under ``MOSHI_TPU_INT8_MAX_M``, as in the JAX package.  The
offline scans (``STSPipeline.scan_frames``, ``STTPipeline.scan_frames``:
Mimi over a whole clip a chunk at a time, then the LM frame by frame,
then, for STS, Mimi decode) and the streaming sessions
(``runtime.session``: ``LMGenerator``, ``MimiStreamer``) drive the same
frames and kernels.  Weights come from files (``runtime.loader``:
safetensors checkpoints, quantized on load by the native quantizer, GGUF
files, and ``runtime.cache``'s quantized cache), and the LM takes the
demuxed text stream, depformer RoPE and gelu gating.  The command-line
tools (``tools``: mimi-encode, mimi-decode, mimi-play, moshi-sts,
moshi-stt, moshi-tts, personaplex) drive these pipelines from files and
live audio devices (``io``).  The parallel layer (``parallel``) runs the
LM frame over several processes on ``torch.distributed``: tensor,
pipeline and expert parallelism and session sharding on a mesh of ranks.

Entry points take ``device=`` and default to ``"cuda"``; without a card
they raise unless the caller asks for ``device="cpu"``, where every kernel
wrapper runs its plain PyTorch version.  The package never imports JAX or
``moshi_tpu``.
"""

__version__ = "0.5.0"

SAMPLE_RATE = 24_000   # Hz, Mimi's audio rate
FRAME_RATE = 12.5      # frames per second
FRAME_SIZE = 1920      # samples per 80 ms frame: SAMPLE_RATE / FRAME_RATE


def __getattr__(name):  # lazy public API (importing the package loads nothing)
    import importlib
    _API = {
        "LMConfig": "moshi_tpu_torch.models.lm",
        "init_gen_state": "moshi_tpu_torch.models.lm",
        "lm_gen_step": "moshi_tpu_torch.models.lm",
        "MimiConfig": "moshi_tpu_torch.models.mimi",
        "MimiModel": "moshi_tpu_torch.models.mimi",
        "STSPipeline": "moshi_tpu_torch.runtime.pipeline",
        "LMGenerator": "moshi_tpu_torch.runtime.session",
        "MimiStreamer": "moshi_tpu_torch.runtime.session",
        "STTPipeline": "moshi_tpu_torch.runtime.pipeline",
        "SessionPool": "moshi_tpu_torch.runtime.serving",
        "TTSPipeline": "moshi_tpu_torch.runtime.pipeline",
        "TTSSessionPool": "moshi_tpu_torch.runtime.serving",
        "TTSModel": "moshi_tpu_torch.models.tts",
        "auto_slots": "moshi_tpu_torch.runtime.serving",
        "load_config": "moshi_tpu_torch.config",
        "QuantTensor": "moshi_tpu_torch.quant.formats",
        "synth_lm_params": "moshi_tpu_torch.runtime.synth",
        "synth_mimi_params": "moshi_tpu_torch.runtime.synth",
        "params_from_numpy": "moshi_tpu_torch.runtime.convert",
        "load_lm_params": "moshi_tpu_torch.runtime.loader",
        "load_mimi_params": "moshi_tpu_torch.runtime.loader",
    }
    if name in _API:
        return getattr(importlib.import_module(_API[name]), name)
    raise AttributeError(name)
