"""String-enum settings shared across the framework.

The same method / noise-type / SDE-type / Levy-area vocabularies as
``torchsde_tpu.settings`` (and torchsde's own settings module), so user code
and tests are written against identical string constants.
"""


class ContainerMeta(type):
    """Metaclass turning a class of string constants into a queryable container."""

    def all(cls):
        return sorted(getattr(cls, name) for name in dir(cls) if not name.startswith("__"))

    def __str__(cls):
        return str(cls.all())

    def __contains__(cls, item):
        return item in cls.all()

    def __iter__(cls):
        return iter(cls.all())


class METHODS(metaclass=ContainerMeta):
    euler = "euler"
    milstein = "milstein"
    srk = "srk"
    midpoint = "midpoint"
    reversible_heun = "reversible_heun"
    adjoint_reversible_heun = "adjoint_reversible_heun"
    heun = "heun"
    log_ode_midpoint = "log_ode"
    euler_heun = "euler_heun"


class NOISE_TYPES(metaclass=ContainerMeta):
    general = "general"
    diagonal = "diagonal"
    scalar = "scalar"
    additive = "additive"


class SDE_TYPES(metaclass=ContainerMeta):
    ito = "ito"
    stratonovich = "stratonovich"


class LEVY_AREA_APPROXIMATIONS(metaclass=ContainerMeta):
    none = "none"            # only Brownian increments W
    space_time = "space-time"  # W plus exact space-time Levy area H (and U)
    davie = "davie"          # W, H plus Davie's approximation to full Levy area A
    foster = "foster"        # W, H plus Foster's correction to Davie's approximation


class METHOD_OPTIONS(metaclass=ContainerMeta):
    grad_free = "grad_free"
