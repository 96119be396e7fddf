from biograph_jax.cli import main

main()
