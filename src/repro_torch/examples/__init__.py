"""The JAX package's example programs (``examples/*.py``) on the port.

One module for each, under the same file name, with the same constants
and function names:

* :mod:`.quickstart` — ``solve()``, the four gradient methods, MALI's
  constant memory and reverse accuracy, batching, reverse time, dense
  output and events;
* :mod:`.image_recognition` — paper Sec 4.2: a residual net against the
  same block as a Neural ODE trained with MALI;
* :mod:`.time_series_latent_ode` — paper Sec 4.3: a latent ODE over
  irregular observation times;
* :mod:`.cnf_toy` and :mod:`.cnf_image` — paper Sec 4.4: continuous
  normalizing flows on a 2-D density and on MNIST-shaped images;
* :mod:`.lm_continuous_depth` — the continuous-depth LM trained, resumed
  after an injected failure, and served.

Each runs as ``python -m repro_torch.examples.<name>``, takes the JAX
example's flags plus ``--device`` (the CUDA card unless ``--device cpu``;
without a card and without that flag it raises), prints what the JAX
example prints, and its ``main(argv)`` returns those figures in a dict.
Wherever an example builds ``ALF`` it runs on ``backend="cuda"``: the
kernels on the card, their plain versions on CPU tensors.
"""
