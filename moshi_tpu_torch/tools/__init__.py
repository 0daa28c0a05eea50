"""The command-line tools, each ``python -m moshi_tpu_torch.tools.<tool>``
or ``main(argv)``: mimi_encode, mimi_decode, mimi_play (and its echo
modes), moshi_sts, moshi_stt, moshi_tts, personaplex."""
