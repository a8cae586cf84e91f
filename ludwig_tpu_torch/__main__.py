"""CLI: `python -m ludwig_tpu_torch [inputfile] [--device cuda]` mirrors
the reference binary, which reads a file named `input` in the cwd (ref:
src/main.c:30-46)."""

from ludwig_tpu_torch.ludwig import main

if __name__ == "__main__":
    main()
