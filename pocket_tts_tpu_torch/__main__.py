from pocket_tts_tpu_torch.api.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
