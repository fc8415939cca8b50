"""Scene 2 (``-bc 2``): striped inflow at the left, four baffles, an outflow
on the middle third of the right edge."""


def paint(cv, x_res: int, y_res: int) -> None:
    cv.bc[:2, :] = (1.0, 0.0)
    cv.mask[:2, :] = 2
    cv.dye[:2, :] = (0.2, 0.2, 1.2)
    stripe = y_res // 10
    for j0 in range(0, y_res, stripe):
        cv.dye[:2, j0:j0 + stripe // 2] = (1.2, 1.2, 0.2)
    cv.box((0, 0), (2, y_res // 3))
    cv.box((0, 2 * y_res // 3), (2, y_res))
    cv.box((x_res - 2, 0), (x_res, y_res))
    cv.box((0, 0), (x_res, 2))
    cv.box((0, y_res - 2), (x_res, y_res))
    xp, yp, size = x_res // 5, y_res // 2, y_res // 32
    for k, (y0, y1) in enumerate(((yp, y_res), (0, yp), (yp, y_res), (0, yp)), start=1):
        cv.box((k * xp - size, y0), (k * xp + size, y1))
    cv.bc[-2:, y_res // 3:2 * y_res // 3] = 0.0
    cv.mask[-2:, y_res // 3:2 * y_res // 3] = 3
